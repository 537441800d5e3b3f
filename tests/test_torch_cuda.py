"""The hand-written CUDA kernels (flash-attention forward and backward, the
SSL crop+photometric and photometric kernels, and the ViT's LayerNorm,
LN + matmul, packed attention and attention half-block) against their plain
PyTorch versions, and the wrappers' refusal of what their kernels do not
take. These need a CUDA card and skip elsewhere; on the GPU machine run

    python -m pytest -m cuda tests/test_torch_cuda.py

(`chip_smoke.py` makes the same comparisons at the CARL and MV-Former
shapes)."""

import pytest
import torch

from video_rep_learning_tpu_torch.ops import (attention, layernorm, matmul,
                                              photometric, vit_block)

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
VIT_FP32_ATOL = {"ln": 1e-5, "mm": 1e-4, "attn": 1e-5, "block": 1e-4}
VIT_BF16_ULPS = {"ln": 1, "mm": 1, "attn": 2, "block": 2}


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
