"""The hand-written CUDA kernels (flash-attention forward and backward, the
SSL crop+photometric and photometric kernels, the ViT's LayerNorm,
LN + matmul, packed attention, attention half-block, matmul + GELU and the
whole MLP half-block, and the four passes of the fused SCL loss) against
their plain PyTorch versions; the ViT kernels' gradients (the kernel
forward, the plain backward chunked over frames) against autograd of the
plain versions; the JAX package's MLP gates reaching their kernels; and the
wrappers' refusal of what their kernels do not take, and of a launch that
would drop a gradient. These need a CUDA card and skip elsewhere; on the GPU machine run

    python -m pytest -m cuda tests/test_torch_cuda.py

(`chip_smoke.py` makes the same comparisons at the CARL and MV-Former
shapes)."""

import pytest
import torch

from video_rep_learning_tpu_torch.ops import (attention, layernorm, matmul,
                                              photometric, scl, vit_block)

pytestmark = pytest.mark.cuda

# fp32: the same math summed in another order. bf16: the kernel rounds its
# output to bf16 (half an ulp of |out| <= ~4 is 2^-8), its LSE stays fp32
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1.6e-2, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(1, 8, 37, 32), (1, 8, 1000, 32),
                                   (2, 8, 240, 32), (1, 8, 6000, 32),
                                   (2, 12, 785, 64)], ids=str)
def test_flash_attn_fwd_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(0)
    B, _, S, d = shape
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for _ in range(3))
    mask = (torch.rand(B, S, generator=g) > 0.1).float()
    mask[:, S - S // 8:] = 0
    if B > 1:
        mask[1] = 0  # a batch row that attends to nothing: mean of V
    mask = mask.to(cuda)
    before = attention.flash_attention_fwd.launches
    out, lse = attention.flash_attention_fwd(q, k, v, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_fwd.launches == before + 1
    ref, ref_lse = attention.attention_reference(q.float(), k.float(),
                                                 v.float(), mask, d ** -0.5)
    out_tol, lse_tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


def test_flash_attn_rejects_bad_head_width(cuda):
    x = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        attention.flash_attention(x, x, x)


# gradients: fp32 sums in another order over up to 6000 keys; bf16: the
# kernel rounds dq, dk, dv to bf16 (an ulp of |g| < 4 is 2^-6), and p and ds
# to bf16 before their products, as the plain version does
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 8, 240, 32), (1, 8, 1000, 32),
                                   (1, 8, 6000, 32), (2, 4, 200, 64)], ids=str)
def test_flash_attn_bwd_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(1)
    B, _, S, d = shape
    q, k, v, dout = (torch.randn(shape, generator=g).to(cuda, dtype)
                     for _ in range(4))
    mask = (torch.rand(B, S, generator=g) > 0.1).float()
    mask[:, S - S // 8:] = 0
    if B > 1:
        mask[1] = 0
    mask = mask.to(cuda)
    out, lse = attention.flash_attention_fwd(q, k, v, mask, d ** -0.5)
    before = attention.flash_attention_bwd.launches
    got = attention.flash_attention_bwd(q, k, v, mask, out, lse, dout, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_bwd.launches == before + 1
    want = attention.attention_backward_reference(q, k, v, mask, out, lse,
                                                  dout, d ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= GRAD_TOL[dtype] * scale


def test_flash_attention_function_runs_both_kernels(cuda):
    q = torch.randn(2, 8, 240, 32, device=cuda, requires_grad=True)
    k, v = torch.randn_like(q), torch.randn_like(q)
    before = (attention.flash_attention_fwd.launches,
              attention.flash_attention_bwd.launches)
    attention.mha_with_flash(q, k, v).square().sum().backward()
    assert (attention.flash_attention_fwd.launches,
            attention.flash_attention_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.isfinite(q.grad).all()


# augmentation: fp32 math on both sides in another order (the resample and
# blur sums, the contrast mean), then /0.224; bf16 output: one ulp of
# |x| < 4 (2^-6), since the fp32 values may sit either side of a rounding
# boundary
AUG_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


def _aug_case(cuda, kind, seed, H=256, W=256, S=224, T=4, BV=4):
    from video_rep_learning_tpu_torch.ops import augment as aug

    gen = torch.Generator().manual_seed(seed)
    dims = [[H - 32, W - 16], [H, W]] if kind == "padded" else None
    s = aug.sample_ssl_batch(gen, BV // 2, 2, H, W, dims, aug.AugmentParams(image_size=S))
    if kind in ("all", "padded"):
        s["fscal"][:, [0, 5, 6, 7]] = 1
    s["orders"] = torch.stack([torch.roll(torch.tensor([1, 0, 2, 3]), i)
                               for i in range(BV)]).to(torch.int32)
    videos = torch.randint(0, 256, (BV, T, 3, H, W), generator=gen, dtype=torch.uint8)
    return ({k: t.to(cuda) for k, t in s.items()}, videos.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["all", "padded", "sampled"])
def test_crop_photometric_matches_plain(cuda, kind, dtype):
    s, videos = _aug_case(cuda, kind, seed=0)
    args = (videos, s["rh"], s["rw"], s["fscal"], s["orders"], s["mh"], s["mw"])
    before = photometric.crop_photometric.launches
    out = photometric.crop_photometric(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert photometric.crop_photometric.launches == before + 1
    want = photometric.crop_photometric_reference(*args, out_dtype=dtype)
    assert out.shape == want.shape and out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= AUG_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_photometric_matches_plain(cuda, dtype):
    s, _ = _aug_case(cuda, "all", seed=1)
    x = torch.rand(4, 3, 3, 224, 224, device=cuda)
    args = (x, s["fscal"], s["orders"], s["mh"], s["mw"])
    before = photometric.photometric.launches
    out = photometric.photometric(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert photometric.photometric.launches == before + 1
    want = photometric.photometric_reference(*args, out_dtype=dtype)
    assert (out.float() - want.float()).abs().max().item() <= AUG_TOL[dtype]


# ---------------------------------------------------------------------------
# the ViT kernels, at the MV-Former chunk (40 x 785 x 768), a ragged last
# chunk (7 frames) and the CPU tests' small shape
# ---------------------------------------------------------------------------

VIT_SHAPES = [(40, 785, 768), (7, 785, 768), (2, 17, 128)]
# fp32: the same fp32 math summed in another order (K <= 768 products,
# values of order 1-10). bf16: both sides round the same fp32 values at the
# same points, so an output may sit one ulp apart (2^-7 of the largest
# value); attention rounds p unnormalised in the kernel and normalised in
# the plain version (two ulps); the half-block composes three rounded
# stages, the last (proj + residual) rounding once from fp32 (two ulps)
# (#9 rounds its activation before fc2 on both sides, then the output: two)
VIT_FP32_ATOL = {"ln": 1e-5, "mm": 1e-4, "attn": 1e-5, "block": 1e-4, "mlp": 1e-4}
VIT_BF16_ULPS = {"ln": 1, "mm": 1, "attn": 2, "block": 2, "mlp": 2}


def _vit_tol(kind, dtype, want):
    if dtype == torch.float32:
        return VIT_FP32_ATOL[kind]
    return VIT_BF16_ULPS[kind] * 2.0 ** -7 * max(1.0, want.float().abs().max().item())


def _vit_inputs(cuda, shape, dtype, seed, F=None):
    g = torch.Generator().manual_seed(seed)
    n, N, D = shape
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    ln_s = (1 + 0.1 * torch.randn(D, generator=g)).to(cuda)
    ln_b = (0.1 * torch.randn(D, generator=g)).to(cuda)
    F = F or 4 * D
    w = (torch.randn(F, D, generator=g) * D ** -0.5).to(cuda, dtype)
    b = (0.1 * torch.randn(F, generator=g)).to(cuda)
    return x, ln_s, ln_b, w, b


def _assert_vit(kind, dtype, got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert err <= _vit_tol(kind, dtype, want), (kind, dtype, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_layernorm_matches_plain(cuda, shape, dtype):
    x, ln_s, ln_b, _, _ = _vit_inputs(cuda, shape, dtype, 2)
    before = layernorm.fused_layernorm.launches
    got = layernorm.fused_layernorm(x, ln_s, ln_b)
    torch.cuda.synchronize()
    assert layernorm.fused_layernorm.launches == before + 1
    _assert_vit("ln", dtype, got, layernorm.layernorm_reference(x, ln_s, ln_b))


@pytest.mark.parametrize("activation", ["none", "gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_ln_matmul_matches_plain(cuda, shape, dtype, activation):
    x, ln_s, ln_b, w, b = _vit_inputs(cuda, shape, dtype, 3)
    before = matmul.ln_matmul_bias_act.launches
    got = matmul.ln_matmul_bias_act(x, ln_s, ln_b, w, b, activation)
    torch.cuda.synchronize()
    assert matmul.ln_matmul_bias_act.launches == before + 1
    want = matmul.ln_matmul_bias_act_reference(x, ln_s, ln_b, w, b, activation)
    _assert_vit("mm", dtype, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_matmul_residual_no_ln_matches_plain(cuda, shape, dtype):
    x, _, _, w, b = _vit_inputs(cuda, shape, dtype, 4, F=shape[-1])
    res = torch.randn_like(x)
    got = matmul.ln_matmul_bias_act(x, None, None, w, b, residual=res)
    want = matmul.ln_matmul_bias_act_reference(x, None, None, w, b, residual=res)
    _assert_vit("mm", dtype, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_packed_attention_matches_plain(cuda, shape, dtype):
    n, N, D = shape
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(n, N, 3 * D, generator=g).to(cuda, dtype)
    before = attention.packed_vit_attention.launches
    got = attention.packed_vit_attention(qkv, D // 64)
    torch.cuda.synchronize()
    assert attention.packed_vit_attention.launches == before + 1
    _assert_vit("attn", dtype, got,
                attention.packed_attention_reference(qkv, D // 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_vit_attention_block_matches_plain(cuda, shape, dtype):
    x, ln_s, ln_b, wqkv, bqkv = _vit_inputs(cuda, shape, dtype, 6, F=3 * shape[-1])
    _, _, _, wp, bp = _vit_inputs(cuda, shape, dtype, 7, F=shape[-1])
    heads = shape[-1] // 64
    before = (vit_block.vit_attention_block.launches,
              matmul.ln_matmul_bias_act.launches,
              attention.packed_vit_attention.launches)
    got = vit_block.vit_attention_block(x, ln_s, ln_b, wqkv, bqkv, wp, bp, heads)
    torch.cuda.synchronize()
    assert (vit_block.vit_attention_block.launches,
            matmul.ln_matmul_bias_act.launches,
            attention.packed_vit_attention.launches) == (
                before[0] + 1, before[1] + 2, before[2] + 1)
    want = vit_block.vit_attention_block_reference(x, ln_s, ln_b, wqkv, bqkv,
                                                   wp, bp, heads)
    _assert_vit("block", dtype, got, want)


def test_layernorm_rejects_bad_input(cuda):
    x = torch.randn(2, 8, 64, device=cuda)
    ones = torch.ones(64, device=cuda)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        layernorm.fused_layernorm(x.half(), ones, ones)
    with pytest.raises(ValueError, match="scale"):
        layernorm.fused_layernorm(x, ones[:32], ones)


def test_ln_matmul_rejects_bad_input(cuda):
    x = torch.randn(2, 8, 96, device=cuda)
    w, b = torch.randn(128, 96, device=cuda), torch.zeros(128, device=cuda)
    with pytest.raises(ValueError, match="K % 32"):
        matmul.ln_matmul_bias_act(x[..., :80].contiguous(), None, None,
                                  w[:, :80].contiguous(), b)
    with pytest.raises(ValueError, match="F % 128"):
        matmul.ln_matmul_bias_act(x, None, None, w[:100].contiguous(), b[:100])
    with pytest.raises(ValueError, match="w must be contiguous"):
        matmul.ln_matmul_bias_act(x, None, None, w.bfloat16(), b)


def test_packed_attention_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="head width"):
        attention.packed_vit_attention(torch.randn(1, 5, 3 * 96, device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.packed_vit_attention(torch.randn(1, 5, 3 * 128, device=cuda)[:, ::2], 2)


def test_vit_attention_block_rejects_bad_input(cuda):
    x = torch.randn(1, 5, 128, device=cuda)
    ones = torch.ones(128, device=cuda)
    wqkv, wp = torch.randn(384, 128, device=cuda), torch.randn(128, 128, device=cuda)
    with pytest.raises(ValueError, match="w must be contiguous"):
        vit_block.vit_attention_block(x, ones, ones, wqkv.bfloat16(),
                                      torch.zeros(384, device=cuda), wp, ones, 2)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_matmul_bias_gelu_matches_plain(cuda, shape, dtype, approximate):
    x, _, _, w, b = _vit_inputs(cuda, shape, dtype, 8)
    before = (matmul.matmul_bias_gelu.launches, matmul.ln_matmul_bias_act.launches)
    got = matmul.matmul_bias_gelu(x, w, b, approximate)
    torch.cuda.synchronize()
    assert (matmul.matmul_bias_gelu.launches,
            matmul.ln_matmul_bias_act.launches) == (before[0] + 1, before[1])
    _assert_vit("mm", dtype, got, matmul.matmul_bias_gelu_reference(x, w, b, approximate))


@pytest.mark.parametrize("activation", ["gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_ln_mlp_block_matches_plain(cuda, shape, dtype, activation):
    x, ln_s, ln_b, w1, b1 = _vit_inputs(cuda, shape, dtype, 9)
    g = torch.Generator().manual_seed(10)
    D = shape[-1]
    w2 = (torch.randn(D, 4 * D, generator=g) * (4 * D) ** -0.5).to(cuda, dtype)
    b2 = (0.1 * torch.randn(D, generator=g)).to(cuda)
    before = matmul.ln_mlp_block.launches
    got = matmul.ln_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, activation)
    torch.cuda.synchronize()
    assert matmul.ln_mlp_block.launches == before + 1
    _assert_vit("mlp", dtype, got, matmul.ln_mlp_block_reference(
        x, ln_s, ln_b, w1, b1, w2, b2, activation))


def test_ln_mlp_block_rejects_bad_input(cuda):
    x = torch.randn(2, 8, 192, device=cuda)
    ones = torch.ones(192, device=cuda)
    w1, w2 = torch.randn(256, 192, device=cuda), torch.randn(192, 256, device=cuda)
    b1 = torch.zeros(256, device=cuda)
    with pytest.raises(ValueError, match="K % 128"):
        matmul.ln_mlp_block(x, ones, ones, w1, b1, w2, ones)
    x, ones = x[..., :128].contiguous(), ones[:128]
    with pytest.raises(ValueError, match="w1 must be"):
        matmul.ln_mlp_block(x, ones, ones, w1, b1, w2, ones)
    w1, w2 = w1[:200, :128].contiguous(), w2[:128, :200].contiguous()
    with pytest.raises(ValueError, match="F % 64"):
        matmul.ln_mlp_block(x, ones, ones, w1, b1[:200], w2, ones)


# the ViT kernels' gradients against autograd of the plain version over all
# frames, each tensor relative to its largest value: fp32 the same math
# summed in another order; bf16 the chunked weight gradients round to bf16
# once a chunk (two ulps, 2^-6)
VIT_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _grad_cases(cuda, dtype):
    x, ln_s, ln_b, w1, b1 = _vit_inputs(cuda, (3, 17, 128), dtype, 11)
    _, _, _, wqkv, bqkv = _vit_inputs(cuda, (3, 17, 128), dtype, 12, F=384)
    _, _, _, wp, bp = _vit_inputs(cuda, (3, 17, 128), dtype, 13, F=128)
    w2 = w1.t().contiguous()
    qkv = torch.randn(3, 17, 384, generator=torch.Generator().manual_seed(14)).to(cuda, dtype)
    return {
        "layernorm": (layernorm.fused_layernorm, layernorm.layernorm_reference,
                      (x, ln_s, ln_b)),
        "ln_gemm": (matmul.ln_matmul_bias_act, matmul.ln_matmul_bias_act_reference,
                    (x, ln_s, ln_b, w1, b1, "gelu_exact")),
        "packed_attn": (attention.packed_vit_attention,
                        attention.packed_attention_reference, (qkv, 2)),
        "vit_attention_block": (vit_block.vit_attention_block,
                                vit_block.vit_attention_block_reference,
                                (x, ln_s, ln_b, wqkv, bqkv, wp, bp, 2)),
        "matmul_bias_gelu": (matmul.matmul_bias_gelu, matmul.matmul_bias_gelu_reference,
                             (x, w1, b1, True)),
        "ln_mlp_block": (matmul.ln_mlp_block, matmul.ln_mlp_block_reference,
                         (x, ln_s, ln_b, w1, b1, w2, bp, "gelu_exact")),
    }


@pytest.mark.parametrize("name", ["layernorm", "ln_gemm", "packed_attn",
                                  "vit_attention_block", "matmul_bias_gelu",
                                  "ln_mlp_block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_vit_kernel_gradients_match_plain(cuda, name, dtype):
    fn, plain, args = _grad_cases(cuda, dtype)[name]
    grads = []
    for f, kw in ((fn, {"grad_chunk": 2}), (plain, {})):
        leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor)
                  else a for a in args]
        y = f(*leaves, **kw)
        ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(15)).to(cuda)
        (y.float() * ct).sum().backward()
        grads.append([a.grad for a in leaves if isinstance(a, torch.Tensor)])
    torch.cuda.synchronize()
    for k, p in zip(*grads):
        assert k.dtype == p.dtype and k.shape == p.shape
        err = (k.float() - p.float()).abs().max().item()
        assert err <= VIT_GRAD_TOL[dtype] * p.float().abs().max().item(), (name, err)


def test_launch_with_grad_outside_the_function_raises(cuda):
    x, ln_s, ln_b, w, b = _vit_inputs(cuda, (2, 17, 128), torch.bfloat16, 16)
    w.requires_grad_()
    for call in (lambda: matmul._ln_matmul_bias_act(x, ln_s, ln_b, w, b, "none", None, 1e-6),
                 lambda: matmul._matmul_bias_gelu(x, w, b, False)):
        with pytest.raises(RuntimeError, match="records no gradient"):
            call()
    with torch.no_grad():
        matmul._matmul_bias_gelu(x, w, b, False)  # no gradient asked for


@pytest.mark.parametrize("gate", ["default", "fused_mlp", "ln_mm_off", "gelu_mm_off"])
def test_mlp_gates_reach_their_kernels(cuda, monkeypatch, gate):
    """A bf16 ViT block under each of the JAX package's MLP gates launches
    the kernels of that route, forward and differentiated."""
    from video_rep_learning_tpu_torch.models.vit import ViTBlock

    env = {"fused_mlp": {"VRL_FUSED_MLP": "1"}, "ln_mm_off": {"VRL_FUSED_LN_MM": "0"},
           "gelu_mm_off": {"VRL_FUSED_GELU_MM": "0"}}.get(gate, {})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # (ln_gemm, ln_mlp_block, matmul_bias_gelu, layernorm) a block
    want = {"default": (3, 0, 0, 0), "fused_mlp": (2, 1, 0, 0),
            "ln_mm_off": (2, 0, 1, 1), "gelu_mm_off": (2, 0, 0, 1)}[gate]
    blk = ViTBlock(128, 2).to(cuda)
    x = torch.randn(3, 17, 128, device=cuda).bfloat16()
    counters = (matmul.ln_matmul_bias_act, matmul.ln_mlp_block,
                matmul.matmul_bias_gelu, layernorm.fused_layernorm)
    before = [c.launches for c in counters]
    y = blk(x)  # grad on: the block's parameters require grad
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert tuple(c.launches - b for c, b in zip(counters, before)) == want
    assert blk.mlp.fc1.weight.grad is not None and blk.attn.qkv.weight.grad is not None


# the fused SCL passes, fp32 on both sides with TF32 off: the same per-pair
# math summed in another order over up to 480 x 512 pairs. Row sums of
# exp(l) (l <= 1 / tau = 10) and the loss rows: 1e-5 relative (+1e-5 for
# rows near 0); the loss 1e-5 relative; the gradient 1e-4 of its largest
# value, as the JAX package holds its fused backward against XLA
SCL_ROW_RTOL, SCL_GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("neg", ["single_noself", "batch_noself"])
@pytest.mark.parametrize("B, T", [(1, 240), (2, 77)], ids=["N480", "N308"])
def test_scl_passes_match_plain(cuda, B, T, neg):
    """Each pass on padded inputs (480 and 308 frames, neither a multiple of
    the 64-row tile), then the loss and gradient through `scl_loss_fused`
    against the plain passes' and `scl_sequence_loss`'s."""
    from video_rep_learning_tpu_torch.algos.scl import scl_sequence_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    e4, lens, steps, masks = scl.sample_inputs(B, T, seed=B, device=cuda)
    N, C = B * 2 * T, e4.shape[-1]
    params = dict(temperature=0.1, label_varience=10.0,
                  single="single" in neg, noself="noself" in neg)
    e, meta = scl.pad_inputs(e4.reshape(N, C), scl.build_meta(lens, steps, masks),
                             scl.block_layout(N))
    before = [f.launches for f in (scl.scl_rowsum, scl.scl_loss_rows, scl.scl_srow,
                                   scl.scl_grad)]
    rows = scl.scl_rowsum(e, meta, **params)
    loss_rows = scl.scl_loss_rows(e, meta, rows, **params)
    s = scl.scl_srow(e, meta, rows, **params)
    de = scl.scl_grad(e, meta, rows, s, **params)
    torch.cuda.synchronize()
    assert [f.launches for f in (scl.scl_rowsum, scl.scl_loss_rows, scl.scl_srow,
                                 scl.scl_grad)] == [b + 1 for b in before]
    want_rows = scl.rowsum_reference(e, meta, **params)
    torch.testing.assert_close(rows, want_rows, rtol=SCL_ROW_RTOL, atol=1e-6)
    torch.testing.assert_close(loss_rows, scl.loss_rows_reference(e, meta, rows, **params),
                               rtol=SCL_ROW_RTOL, atol=1e-5)
    torch.testing.assert_close(s, scl.srow_reference(e, meta, rows, **params),
                               rtol=SCL_ROW_RTOL, atol=1e-6)
    want_de = scl.grad_reference(e, meta, rows, s, **params)
    assert (de - want_de).abs().max().item() <= SCL_GRAD_TOL * want_de.abs().max().item()
    assert not rows[N:].any() and not de[N:].any()

    got_e, want_e = (e4.clone().requires_grad_() for _ in range(2))
    got = scl.scl_loss_fused(got_e, lens, steps, masks, 0.1, 10.0, neg)
    got.backward()
    want = scl_sequence_loss(want_e, lens, steps, masks, temperature=0.1,
                             label_varience=10.0, negative_type=neg)["loss"]
    want.backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    err = (got_e.grad - want_e.grad).abs().max().item()
    assert err <= SCL_GRAD_TOL * want_e.grad.abs().max().item()


def test_scl_rejects_bad_input(cuda):
    kw = dict(temperature=0.1, label_varience=10.0, single=True, noself=True)
    meta = torch.zeros(8, 64, device=cuda)
    with pytest.raises(ValueError, match="C % 16 == 0"):
        scl.scl_rowsum(torch.zeros(64, 136, device=cuda), meta, **kw)
    with pytest.raises(ValueError, match="Np % 64 == 0"):
        scl.scl_rowsum(torch.zeros(60, 128, device=cuda), meta[:, :60].contiguous(),
                       **kw)
    with pytest.raises(ValueError, match="contiguous fp32"):
        scl.scl_rowsum(torch.zeros(64, 128, device=cuda).double(), meta, **kw)
    with pytest.raises(ValueError, match="rows must be"):
        scl.scl_srow(torch.zeros(64, 128, device=cuda), meta,
                     torch.zeros(64, 3, device=cuda), **kw)
