"""The hand-written CUDA kernels (flash-attention forward and backward, the
SSL crop+photometric and photometric kernels, the ViT's LayerNorm,
LN + matmul, packed attention, attention half-block, matmul + GELU and the
whole MLP half-block, and the four passes of the fused SCL loss; and the
kernels of the H100 micro-benchmarks: the packed-attention variants, the
int8 / bf16 tensor-core GEMM and the elementwise chain) against
their plain PyTorch versions; the ViT kernels' gradients (the kernel
forward, the plain backward chunked over frames) against autograd of the
plain versions; the JAX package's MLP gates reaching their kernels; and the
wrappers' refusal of what their kernels do not take, and of a launch that
would drop a gradient; #1 at the FineGym eval chunk's (1, 8, 12000, 32),
a small late-fusion ViT's embeddings and the FineGym probe, card vs CPU;
the trainer's device prefetch (pinned buffers, the copy stream, the compute
stream's wait) delivering each batch exactly while the compute stream is
still busy with the one before.
These need a CUDA card and skip elsewhere; on the GPU machine run

    python -m pytest -m cuda tests/test_torch_cuda.py

(`chip_smoke.py` makes the same comparisons at the CARL and MV-Former
shapes)."""

import pytest
import torch

from video_rep_learning_tpu_torch.ops import (elementwise_chain, int8_matmul)
from video_rep_learning_tpu_torch.ops import (attention, layernorm, matmul,
                                              photometric, scl, vit_block)
from video_rep_learning_tpu_torch.tools import (bench_attn_variants,
                                                bench_packed_attn, bench_vpu_bf16)

pytestmark = pytest.mark.cuda

# fp32: the same math summed in another order. bf16: the kernel rounds its
# output to bf16 (half an ulp of |out| <= ~4 is 2^-8), its LSE stays fp32
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1.6e-2, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "no_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
# chip_smoke.py's cases (`phase_kernel_vs_plain`): key lengths from under
# one 64-key step to 6000, the CARL training and MV-Former encoder shapes,
# both head widths; each block layout (16, 32 and 64 rows) is reached
@pytest.mark.parametrize("shape", [(1, 8, 37, 32), (1, 8, 128, 32), (1, 8, 240, 32),
                                   (1, 8, 600, 32), (1, 8, 1000, 32),
                                   (2, 8, 240, 32), (2, 8, 720, 32), (1, 8, 6000, 32),
                                   (2, 12, 785, 64)], ids=str)
def test_flash_attn_fwd_matches_plain(cuda, shape, dtype, masked):
    """The forward kernel against `attention_reference` in fp32 on the same
    values, masked (padded tail keys, and with B > 1 a batch row that
    attends to nothing: the mean of V) or not; a second launch bit for
    bit."""
    g = torch.Generator().manual_seed(0)
    B, _, S, d = shape
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for _ in range(3))
    mask = None
    if masked:
        mask = (torch.rand(B, S, generator=g) > 0.1).float()
        mask[:, S - S // 8:] = 0
        if B > 1:
            mask[1] = 0
        mask = mask.to(cuda)
    before = attention.flash_attention_fwd.launches
    out, lse = attention.flash_attention_fwd(q, k, v, mask, d ** -0.5)
    again = attention.flash_attention_fwd(q, k, v, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_fwd.launches == before + 2
    ref, ref_lse = attention.attention_reference(q.float(), k.float(),
                                                 v.float(), mask, d ** -0.5)
    out_tol, lse_tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def test_flash_attn_rejects_bad_head_width(cuda):
    x = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        attention.flash_attention(x, x, x)
    # the forward stages its tiles with 16-byte copies
    y = torch.randn(2 * 8 * 32 + 2, device=cuda)[2:].view(1, 2, 8, 32)
    with pytest.raises(ValueError, match="16-byte aligned for the forward"):
        attention.flash_attention_fwd(y, y, y)


# gradients: fp32 sums in another order over up to 6000 keys; bf16: the
# kernel rounds dq, dk, dv to bf16 (an ulp of |g| < 4 is 2^-6), and p and ds
# to bf16 before their products, as the plain version does
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}


def _bwd_case(cuda, shape, dtype, seed=1):
    """q, k, v, dO of `shape`, a key mask with padded tail keys and (B > 1)
    a fully masked batch row, and the forward kernel's out and LSE."""
    g = torch.Generator().manual_seed(seed)
    B, _, S, d = shape
    q, k, v, dout = (torch.randn(shape, generator=g).to(cuda, dtype)
                     for _ in range(4))
    mask = (torch.rand(B, S, generator=g) > 0.1).float()
    mask[:, S - S // 8:] = 0
    if B > 1:
        mask[1] = 0
    mask = mask.to(cuda)
    out, lse = attention.flash_attention_fwd(q, k, v, mask, d ** -0.5)
    return q, k, v, mask, out, lse, dout


def _check_bwd(cuda, shape, dtype):
    args = _bwd_case(cuda, shape, dtype)
    d = shape[-1]
    before = attention.flash_attention_bwd.launches
    got = attention.flash_attention_bwd(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_bwd.launches == before + 1
    want = attention.attention_backward_reference(*args, d ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= GRAD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 8, 240, 32), (2, 8, 720, 32), (1, 8, 1000, 32),
                                   (1, 8, 6000, 32), (2, 4, 200, 64)], ids=str)
def test_flash_attn_bwd_matches_plain(cuda, shape, dtype):
    _check_bwd(cuda, shape, dtype)


# the kernel's edges: lengths that are no multiple of its 32-row tiles and
# 64-row steps, a single query, both head widths; each with a fully masked
# batch row
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("S", [1, 37, 130])
def test_flash_attn_bwd_edges_match_plain(cuda, S, d, dtype):
    _check_bwd(cuda, (2, 3, S, d), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 8, 240, 32), (2, 4, 130, 64)], ids=str)
def test_flash_attn_bwd_is_deterministic(cuda, shape, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    args = _bwd_case(cuda, shape, dtype, seed=2)
    first = attention.flash_attention_bwd(*args, shape[-1] ** -0.5)
    second = attention.flash_attention_bwd(*args, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _strip_case(cuda, S, H, W, boxes, jitter, T=2, seed=0):
    """Views of the given crop boxes on an H x W canvas: contrast at each of
    the four positions in turn, blur on every other view (sigma 0.1 / 2.0),
    gray on the second, flip on the third and fourth; jitter on or off."""
    from video_rep_learning_tpu_torch.ops import augment as aug

    gen = torch.Generator().manual_seed(seed)
    BV = len(boxes)
    fscal = torch.zeros(BV, 8)
    fscal[:, 1:4] = torch.rand(BV, 3, generator=gen) + 0.5
    fscal[:, 4] = torch.rand(BV, generator=gen) * 0.4 - 0.2
    fscal[:, 0] = float(jitter)
    fscal[:, 5] = torch.tensor([float(i % 2 == 0) for i in range(BV)])
    fscal[1 % BV, 6] = 1
    fscal[2 % BV:, 7] = 1
    orders = torch.stack([torch.roll(torch.tensor([1, 0, 2, 3]), i)
                          for i in range(BV)]).to(torch.int32)
    sigmas = torch.tensor([0.1, 2.0] * BV)[:BV]
    m = aug.ssl_matrices(torch.tensor(boxes, dtype=torch.float32), sigmas, H, W, S)
    videos = torch.randint(0, 256, (BV, T, 3, H, W), generator=gen, dtype=torch.uint8)
    args = (videos, m["rh"], m["rw"], fscal, orders, m["mh"], m["mw"])
    return tuple(t.to(cuda) for t in args)


# the crop kernel's strips and bands (csrc/photometric.cu, ops/photometric.py
# crop_plan): output sizes whose 8 strips do not divide them (9: five strips
# hold rows, three are empty; 100: 13-row strips and a 9-row last one; 512:
# strips computed in chunks, the mean in a sweep of its own), boxes the crop
# upsamples and boxes reading (nearly) all of a 512-row canvas
STRIP_CASES = {
    "S9": (9, 40, 36, [(0, 0, 40, 36), (3, 5, 30, 28), (10, 2, 12, 20), (1, 1, 38, 34)]),
    "S100": (100, 256, 256, [(0, 0, 256, 256), (20, 30, 220, 200), (5, 7, 240, 249),
                              (40, 60, 180, 190)]),
    "S512": (512, 512, 512, [(0, 0, 512, 512), (7, 3, 480, 500), (30, 40, 450, 460),
                              (1, 2, 510, 509)]),
    "upsample": (224, 256, 256, [(100, 80, 40, 50), (0, 0, 16, 16), (200, 210, 56, 46),
                                 (3, 9, 120, 90)]),
    "most of 512": (224, 512, 512, [(0, 0, 512, 512), (2, 1, 507, 509), (5, 0, 500, 512),
                                    (0, 6, 512, 490)]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "no_jitter"])
@pytest.mark.parametrize("case", list(STRIP_CASES))
def test_crop_strips_match_plain(cuda, case, jitter, dtype):
    S, H, W, boxes = STRIP_CASES[case]
    args = _strip_case(cuda, S, H, W, boxes, jitter)
    before = photometric.crop_photometric.launches
    out = photometric.crop_photometric(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert photometric.crop_photometric.launches == before + 1
    want = photometric.crop_photometric_reference(*args, out_dtype=dtype)
    assert out.shape == want.shape and out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= AUG_TOL[dtype]


@pytest.mark.parametrize("case", ["S100", "S512", "most of 512"])
def test_crop_photometric_is_deterministic(cuda, case):
    """The frame mean is summed in a fixed order across the cluster: two
    launches agree bit for bit."""
    S, H, W, boxes = STRIP_CASES[case]
    args = _strip_case(cuda, S, H, W, boxes, True, seed=1)
    first = photometric.crop_photometric(*args, out_dtype=torch.float32)
    second = photometric.crop_photometric(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_split_route_takes_a_1080p_canvas(cuda, monkeypatch, capsys):
    """Under USE_AMP a 1080 x 1920 canvas, which the crop kernel's plan
    refuses, goes through `ssl_batch_augment`'s split route (the resample in
    chunks of frames, then the photometric-only kernel), against the plain
    pipeline on the same sampled values; its peak memory stays under half
    the fp32 canvas the resample would hold in one piece."""
    from video_rep_learning_tpu_torch.ops import augment as aug

    monkeypatch.delenv("VRL_FUSED_CROP", raising=False)
    B, V, T, H, W, S = 1, 2, 24, 1080, 1920, 224
    p = aug.AugmentParams(image_size=S, use_amp=True)
    gen = torch.Generator().manual_seed(3)
    sampled = aug.sample_ssl_batch(gen, B, V, H, W, None, p)
    sampled["fscal"][:, 0] = 1  # jitter on: the contrast mean runs
    videos = torch.randint(0, 256, (B, V, T, H, W, 3), generator=gen,
                           dtype=torch.uint8).to(cuda)
    counts = lambda: (aug.ssl_batch_augment.crop_route,  # noqa: E731
                      aug.ssl_batch_augment.split_route,
                      photometric.crop_photometric.launches, photometric.photometric.launches)
    before = counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = aug.ssl_batch_augment(videos, sampled, p)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 0, 1)
    m = {k: t.to(cuda) for k, t in sampled.items()}
    planar = videos.reshape(B * V, T, H, W, 3).permute(0, 1, 4, 2, 3).contiguous()
    want = photometric.crop_photometric_reference(
        planar, m["rh"], m["rw"], m["fscal"], m["orders"], m["mh"], m["mw"],
        torch.bfloat16).view(B, V, T, 3, S, S).permute(0, 1, 2, 4, 5, 3)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert (out.float() - want.float()).abs().max().item() <= AUG_TOL[torch.bfloat16]
    whole = B * V * T * 3 * H * W * 4
    with capsys.disabled():
        print(f"\nsplit route, {B * V} x {T} frames of {H} x {W} -> {S}: peak "
              f"{peak / 2 ** 20:.1f} MiB above the canvas (the fp32 canvas in one "
              f"piece: {whole / 2 ** 20:.1f} MiB)")
    assert peak < whole / 2


def _tail_case(cuda, S, jitter, contrast_at, T=2, seed=0):
    """Four views of cropped fp32 frames: contrast at position `contrast_at`
    of every view's op order (the others rolled around it), blur on every
    other view (sigma 0.1 / 2.0), gray on the second, flip on the third and
    fourth; jitter on or off."""
    from video_rep_learning_tpu_torch.ops import augment as aug

    gen = torch.Generator().manual_seed(seed)
    BV = 4
    fscal = torch.zeros(BV, 8)
    fscal[:, 1:4] = torch.rand(BV, 3, generator=gen) + 0.5
    fscal[:, 4] = torch.rand(BV, generator=gen) * 0.4 - 0.2
    fscal[:, 0] = float(jitter)
    fscal[:, 5] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    fscal[1, 6] = 1
    fscal[2:, 7] = 1
    orders = []
    for i in range(BV):
        rest = torch.roll(torch.tensor([0, 2, 3]), i).tolist()
        orders.append(rest[:contrast_at] + [1] + rest[contrast_at:])
    orders = torch.tensor(orders, dtype=torch.int32)
    boxes = torch.tensor([(0.0, 0.0, S, S)] * BV)
    m = aug.ssl_matrices(boxes, torch.tensor([0.1, 2.0, 0.1, 2.0]), S, S, S)
    x = torch.rand(BV, T, 3, S, S, generator=gen)
    return tuple(t.to(cuda) for t in (x, fscal, orders, m["mh"], m["mw"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("contrast_at", [0, 1, 2, 3])
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "no_jitter"])
# S 9: rows of 36 bytes (4-byte loads, no bulk copy), five strips empty;
# S 100: 7-row strips, rows of 400 bytes (bulk copies, 4-byte stores);
# S 224: the training shape; S 512: strips in chunks, the mean in a sweep of
# its own
@pytest.mark.parametrize("S", [9, 100, 224, 512])
def test_photometric_matches_plain(cuda, S, jitter, contrast_at, dtype):
    args = _tail_case(cuda, S, jitter, contrast_at)
    before = photometric.photometric.launches
    out = photometric.photometric(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert photometric.photometric.launches == before + 1
    want = photometric.photometric_reference(*args, out_dtype=dtype)
    assert out.shape == want.shape and out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= AUG_TOL[dtype]


@pytest.mark.parametrize("S", [9, 100, 224, 512])
def test_photometric_is_deterministic(cuda, S):
    """The frame mean is summed in a fixed order across the cluster: two
    launches agree bit for bit."""
    args = _tail_case(cuda, S, True, 2, seed=1)
    first = photometric.photometric(*args, out_dtype=torch.float32)
    second = photometric.photometric(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_photometric_refuses_grad(cuda):
    """Frames that require grad with grad mode on would lose their gradient
    through the kernel: refused before any launch; with grad mode off the
    kernel runs."""
    x, fscal, orders, mh, mw = _tail_case(cuda, 100, True, 0)
    before = photometric.photometric.launches
    with pytest.raises(RuntimeError, match="records no gradient"):
        photometric.photometric(x.requires_grad_(), fscal, orders, mh, mw)
    assert photometric.photometric.launches == before
    with torch.no_grad():
        photometric.photometric(x, fscal, orders, mh, mw)
    assert photometric.photometric.launches == before + 1


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


# the tensor-core kernels of #4 and #6 (bf16) at every shape their wrappers
# take on the model paths and the edges of their tiling
ATTN_FORMS = {"max-free": "0", "maxsub": "1"}


@pytest.mark.parametrize("form", list(ATTN_FORMS))
@pytest.mark.parametrize("B", [1, 7, 40])
@pytest.mark.parametrize("N", [785, 17, 64])
@pytest.mark.parametrize("dh", [32, 64])
def test_packed_attention_bf16_forms_match_plain(cuda, monkeypatch, dh, N, B, form):
    heads = 256 // dh
    monkeypatch.setenv("VRL_ATTN_MAXSUB", ATTN_FORMS[form])
    g = torch.Generator(device=cuda).manual_seed(15)
    qkv = torch.randn(B, N, 3 * heads * dh, generator=g, device=cuda).bfloat16()
    before = attention.packed_vit_attention.launches
    got = attention.packed_vit_attention(qkv, heads)
    torch.cuda.synchronize()
    assert attention.packed_vit_attention.launches == before + 1
    want = attention.packed_attention_reference(qkv, heads)
    # two bf16 ulps of the largest output, not floored at 1: the kernel
    # rounds p unnormalised (against the running max with maxsub), the plain
    # version normalised, and each rounds the output once
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert err <= 2 * 2.0 ** -7 * want.float().abs().max().item(), (form, err)


# (activation, residual, LN): each activation with and without the residual
# under the LN, and the two LN-off forms the model runs (proj + residual, #7)
GEMM_EPILOGUES = [(act, res, True) for act in ("none", "gelu_exact", "gelu_tanh")
                  for res in (False, True)] + [("none", True, False),
                                               ("gelu_exact", False, False)]


@pytest.mark.parametrize("M", [1, 63, 31400])
@pytest.mark.parametrize("F", [128, 768, 2304, 3072])
@pytest.mark.parametrize("K", [384, 768, 1024, 1536])
def test_ln_matmul_bf16_shapes_match_plain(cuda, K, F, M):
    g = torch.Generator(device=cuda).manual_seed(16)

    def r(*s):
        return torch.randn(*s, generator=g, device=cuda)

    x = (r(M, K) * 2 + 0.5).bfloat16()
    ln_s, ln_b = 1 + 0.1 * r(K), 0.1 * r(K)
    w, b = (r(F, K) * K ** -0.5).bfloat16(), 0.1 * r(F)
    res = r(M, F).bfloat16()
    for act, with_res, ln in GEMM_EPILOGUES:
        args = (x, ln_s if ln else None, ln_b if ln else None, w, b, act)
        residual = res if with_res else None
        before = matmul.ln_matmul_bias_act.launches
        got = matmul.ln_matmul_bias_act(*args, residual=residual)
        torch.cuda.synchronize()
        assert matmul.ln_matmul_bias_act.launches == before + 1
        want = matmul.ln_matmul_bias_act_reference(*args, residual=residual)
        _assert_vit("mm", torch.bfloat16, got, want)


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


# #9 at the ViT shapes (F = 4 K), then where its tiling breaks first: rows
# below one 64-row panel and not a multiple of 64, K 384 (ViT-S: three
# 64-column fc2 blocks a warpgroup) beside 768 and 128, and F a multiple of
# 64 but not of 128
MLP_SHAPES = [(shape, 4 * shape[-1]) for shape in VIT_SHAPES] + [
    ((1, 1, 768), 3072), ((1, 50, 768), 3072), ((1, 100, 384), 1536),
    ((3, 43, 384), 192), ((2, 17, 128), 192), ((1, 130, 768), 192)]


@pytest.mark.parametrize("activation", ["none", "gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,F", MLP_SHAPES, ids=str)
def test_ln_mlp_block_matches_plain(cuda, shape, F, dtype, activation):
    x, ln_s, ln_b, w1, b1 = _vit_inputs(cuda, shape, dtype, 9, F)
    g = torch.Generator().manual_seed(10)
    D = shape[-1]
    w2 = (torch.randn(D, F, generator=g) * F ** -0.5).to(cuda, dtype)
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
# math summed in another order over up to 8640 x 8640 pairs. Row sums of
# exp(l) (l <= 1 / tau = 10) and the loss rows: 1e-5 relative (+1e-5 for
# rows near 0); the loss 1e-5 relative; the gradient 1e-4 of its largest
# value, as the JAX package holds its fused backward against XLA
SCL_ROW_RTOL, SCL_GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("neg", ["single_noself", "batch_noself"])
@pytest.mark.parametrize("B, T, C", [(1, 240, 128), (18, 240, 128), (2, 77, 128), (2, 77, 32)],
                         ids=["N480", "N8640", "N308", "N308_C32"])
def test_scl_passes_match_plain(cuda, B, T, C, neg):
    """Each pass on padded inputs (480 and 308 frames, neither a multiple of
    the 64-row tile, and the auto gate's 8640; the embedding width 128 and
    a narrower 32) over the tiles `scl_tiles` flags, against the plain
    passes; a second launch bit for bit, and the same bits again walking
    every tile (an empty tile adds exact zeros); then the loss and gradient
    through `scl_loss_fused` against `scl_sequence_loss`'s."""
    from video_rep_learning_tpu_torch.algos.scl import scl_sequence_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    e4, lens, steps, masks = scl.sample_inputs(B, T, seed=B, C=C, device=cuda)
    N = B * 2 * T
    flags = dict(single="single" in neg, noself="noself" in neg)
    params = dict(temperature=0.1, label_varience=10.0, **flags)
    e, meta = scl.pad_inputs(e4.reshape(N, C), scl.build_meta(lens, steps, masks),
                             scl.block_layout(N))
    tiles = scl.scl_tiles(meta, B, 2, **flags)
    assert torch.equal(tiles, scl.tiles_reference(meta, **flags))

    def passes(walk):
        rows = scl.scl_rowsum(e, meta, walk, **params)
        loss_rows = scl.scl_loss_rows(e, meta, rows, walk, **params)
        s = scl.scl_srow(e, meta, rows, walk, **params)
        return rows, loss_rows, s, scl.scl_grad(e, meta, rows, s, walk, **params)

    counters = (scl.scl_rowsum, scl.scl_loss_rows, scl.scl_srow, scl.scl_grad)
    before = [f.launches for f in counters]
    rows, loss_rows, s, de = got = passes(tiles)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 1 for b in before]
    assert all(torch.equal(a, b) for a, b in zip(got, passes(tiles)))
    assert all(torch.equal(a, b) for a, b in zip(got, passes(None)))
    want_rows = scl.rowsum_reference(e, meta, **params)
    torch.testing.assert_close(rows, want_rows, rtol=SCL_ROW_RTOL, atol=1e-6)
    torch.testing.assert_close(loss_rows, scl.loss_rows_reference(e, meta, rows, **params),
                               rtol=SCL_ROW_RTOL, atol=1e-5)
    torch.testing.assert_close(s, scl.srow_reference(e, meta, rows, **params),
                               rtol=SCL_ROW_RTOL, atol=1e-6)
    want_de = scl.grad_reference(e, meta, rows, s, **params)
    assert (de - want_de).abs().max().item() <= SCL_GRAD_TOL * want_de.abs().max().item()
    assert not rows[N:].any() and not de[N:].any()
    del want_rows, want_de

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
    with pytest.raises(ValueError, match="tiles must be a contiguous uint8"):
        scl.scl_rowsum(torch.zeros(64, 128, device=cuda), meta,
                       torch.ones(2, 2, dtype=torch.uint8, device=cuda), **kw)


# the micro-benchmark kernels: one small and one ragged shape each. Both
# schedules of tools/bench_ln_matmul.py run #6 (its kernel normalises each
# row panel once), so the LN-once case is #6 at the script's bf16
@pytest.mark.parametrize("shape,F", [((1, 64, 128), 128), ((2, 100, 768), 384)],
                         ids=str)
def test_ln_matmul_ln_once_matches_plain(cuda, shape, F):
    dtype = torch.bfloat16  # the TPU script's type
    x, ln_s, ln_b, w, b = _vit_inputs(cuda, shape, dtype, 11, F=F)
    before = matmul.ln_matmul_bias_act.launches
    got = matmul.ln_matmul_bias_act(x, ln_s, ln_b, w, b, "gelu_exact")
    torch.cuda.synchronize()
    assert matmul.ln_matmul_bias_act.launches == before + 1
    want = matmul.ln_matmul_bias_act_reference(x, ln_s, ln_b, w, b, "gelu_exact")
    _assert_vit("mm", dtype, got, want)


# (exp2, nomax, bf16p, block_q, heads a block, images a block): four of
# this file's own, then the eleven VARIANTS of the two tools (heads and
# images a block cut to the shape's H and B)
ATTN_VARIANTS = [(False, False, False, 64, 1, 1), (True, False, False, 256, 2, 1),
                 (True, True, False, 64, 2, 2), (True, True, True, 64, 4, 1)]
ATTN_VARIANTS += [(*v[:3], 64, *v[3:]) for v in bench_packed_attn.VARIANTS.values()]
ATTN_VARIANTS += [(*v[:3], v[5], *v[3:5]) for v in bench_attn_variants.VARIANTS.values()]


@pytest.mark.parametrize("variant", ATTN_VARIANTS, ids=str)
# N below one 64-key tile, N past two tiles with a ragged end (and past one
# 256-row query tile), a block whose items outnumber its warpgroups, the
# TPU scripts' shape
@pytest.mark.parametrize("shape", [(2, 64, 2), (2, 300, 4), (4, 17, 2), (8, 130, 12),
                                   (40, 785, 12)], ids=str)
def test_packed_attention_variant_matches_plain(cuda, shape, variant):
    B, N, H = shape
    exp2, nomax, bf16p, bq, hpb, ipb = variant
    flags = dict(exp2=exp2, nomax=nomax, bf16p=bf16p)
    g = torch.Generator().manual_seed(12)
    qkv = (torch.randn(B, N, 3 * H * 64, generator=g) * 0.3).to(cuda, torch.bfloat16)
    before = attention.packed_attention_variant.launches
    got = attention.packed_attention_variant(
        qkv, H, **flags, block_q=bq, heads_per_block=min(hpb, H),
        images_per_block=min(ipb, B))
    torch.cuda.synchronize()
    assert attention.packed_attention_variant.launches == before + 1
    want = attention.packed_attention_variant_reference(qkv, H, **flags)
    # two bf16 ulps of the largest output, not floored at 1: the outputs are
    # means of N values of 0.3 randn, of order 0.01-0.1
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert err <= 2 * 2.0 ** -7 * want.float().abs().max().item(), (variant, err)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=str)
# the TPU script's fc1 shape, the smallest the kernel takes, and a K of
# eight int8 stages (sixteen bf16) with one 128-row panel of output tiles
@pytest.mark.parametrize("M,K,F", [(128, 64, 128), (256, 96, 384), (31360, 768, 3072),
                                   (128, 32, 128), (384, 1024, 256)], ids=str)
def test_tc_matmul_matches_plain(cuda, M, K, F, dtype):
    g = torch.Generator().manual_seed(13)
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
        w = torch.randint(-127, 128, (K, F), generator=g, dtype=torch.int8).to(cuda)
    else:
        x = torch.randn(M, K, generator=g).to(cuda, dtype)
        w = torch.randn(K, F, generator=g).to(cuda, dtype)
    before = int8_matmul.tc_matmul.launches
    got = int8_matmul.tc_matmul(x, w)
    torch.cuda.synchronize()
    assert int8_matmul.tc_matmul.launches == before + 1
    want = int8_matmul.tc_matmul_reference(x, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.int8:  # exact int32 sums
        assert torch.equal(got, want)
    else:  # exact products summed in fp32 in another order
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("mode", list(elementwise_chain.MODES), ids=str)
@pytest.mark.parametrize("reps", [0, 1, 7, 480])
# 4096: whole blocks of 256 threads x 8 values; 1003 and 4101: a last thread
# with fewer than 8 values (an odd count in bf16), in a part-filled block
@pytest.mark.parametrize("n", [4096, 1003, 4101])
def test_elementwise_chain_matches_plain_bit_for_bit(cuda, n, reps, mode):
    store, math = mode
    g = torch.Generator().manual_seed(14)
    x = torch.rand(n, generator=g).to(cuda, store)
    before = elementwise_chain.elementwise_chain.launches
    got = elementwise_chain.elementwise_chain(x, reps, math)
    torch.cuda.synchronize()
    assert elementwise_chain.elementwise_chain.launches == before + 1
    assert torch.equal(got, elementwise_chain.elementwise_chain_reference(x, reps, math))


@pytest.mark.parametrize("mode", list(elementwise_chain.MODES), ids=str)
@pytest.mark.parametrize("reps", [0, 1, 2, 5, 48])
def test_elementwise_chain_keeps_nan(cuda, reps, mode):
    """NaN, ±inf, -0.5, 1.5, -0.0 and values at the threshold: NaN where the
    plain version (torch.clamp) keeps NaN, the same bits everywhere else."""
    store, math = mode
    x = bench_vpu_bf16.special_values(store, cuda)
    got = elementwise_chain.elementwise_chain(x, reps, math)
    want = elementwise_chain.elementwise_chain_reference(x, reps, math)
    torch.cuda.synchronize()
    assert int(torch.isnan(want).sum()) == 2
    assert bench_vpu_bf16.same_or_both_nan(got, want)


def test_micro_benchmark_kernels_reject_bad_input(cuda):
    x = torch.zeros(100, 64, dtype=torch.int8, device=cuda)
    w = torch.zeros(64, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="M % 128"):
        int8_matmul.tc_matmul(x, w)
    with pytest.raises(TypeError, match="int8 or both bf16"):
        int8_matmul.tc_matmul(x.bfloat16(), w)
    qkv = torch.zeros(2, 5, 3 * 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        attention.packed_attention_variant(qkv, 2, exp2=True, nomax=True,
                                           bf16p=False, block_q=128)
    with pytest.raises(TypeError, match="bf16"):
        attention.packed_attention_variant(qkv.float(), 2, exp2=True, nomax=True,
                                           bf16p=False)
    # the kernel's TMA tensor map: a 16-byte aligned qkv
    misaligned = torch.zeros(2 * 5 * 384 + 4, device=cuda,
                             dtype=torch.bfloat16)[4:].view(2, 5, 384)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.packed_attention_variant(misaligned, 2, exp2=True, nomax=True,
                                           bf16p=False)
    with pytest.raises(TypeError, match="math"):
        elementwise_chain.elementwise_chain(torch.zeros(8, device=cuda), 2,
                                            torch.bfloat16)
    # #6's bf16 kernel: a misaligned x (its 16 B loads), K past its panel
    _, ln_s, ln_b, w, b = _vit_inputs(cuda, (1, 64, 128), torch.bfloat16, 11, F=128)
    x = torch.zeros(64 * 128 + 4, device=cuda, dtype=torch.bfloat16)[4:].view(1, 64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul.ln_matmul_bias_act(x, ln_s, ln_b, w, b, "gelu_exact")
    x = torch.zeros(2, 8, 1568, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K <= 1536"):
        matmul.ln_matmul_bias_act(
            x, None, None, torch.zeros(128, 1568, device=cuda, dtype=torch.bfloat16),
            torch.zeros(128, device=cuda))


def test_tcc_transformer_step_matches_cpu(cuda):
    """One fp32 TCC training step of a small transformer CARL model (2 clips
    x 12 frames at 32 px, a 2-layer encoder of 2 heads x 32) on the card
    launches the flash forward (#1) and backward (#3) once an encoder layer,
    and gives the CPU's loss and gradients (TF32 off): the loss to 1e-5, each
    gradient tensor to 2e-3 of its largest value, at least 1% of the step's
    largest (`chip_smoke.py`'s STEP_TOL rule: the same fp32 math summed in
    another order; layer4 is left out, as there)."""
    from video_rep_learning_tpu_torch.algos import TCC
    from video_rep_learning_tpu_torch.config import get_cfg
    from video_rep_learning_tpu_torch.models import build_model, set_trainable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_cfg()
    cfg.SSL, cfg.TRAINING_ALGO, cfg.USE_AMP, cfg.IMAGE_SIZE = False, "tcc", False, 32
    cfg.TRAIN.NUM_FRAMES = 12
    cfg.MODEL.PROJECTION = cfg.MODEL.L2_NORMALIZE = False
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS, e.HIDDEN_SIZE, e.NUM_HEADS, e.D_FF = 2, 64, 2, 64
    e.FC_LAYERS, e.CAPACITY_SCALAR, e.EMBEDDING_SIZE = [[32, True], [32, True]], 1, 16
    e.FC_DROPOUT_RATE = 0.0
    g = torch.Generator().manual_seed(0)
    videos = (torch.randn(2, 12, 32, 32, 3, generator=g)
              * torch.rand(2, 12, 1, 1, 1, generator=g) * 2
              + torch.randn(2, 12, 1, 1, 3, generator=g))
    batch = {"videos": videos, "video_masks": torch.ones(2, 12),
             "seq_lens": torch.tensor([40, 31]),
             "chosen_steps": torch.stack([torch.randperm(n, generator=g)[:12].sort().values
                                          for n in (40, 31)])}
    out = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(0)
        model = build_model(cfg, dev)
        set_trainable(model, cfg.MODEL.TRAIN_BASE)
        model.train()
        before = (attention.flash_attention_fwd.launches,
                  attention.flash_attention_bwd.launches)
        loss = TCC(cfg).compute_loss(model, {k: v.to(dev) for k, v in batch.items()})["loss"]
        loss.backward()
        launched = (attention.flash_attention_fwd.launches - before[0],
                    attention.flash_attention_bwd.launches - before[1])
        assert launched == ((2, 2) if dev == "cuda" else (0, 0))
        out[dev] = loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()
                                 if p.grad is not None and not n.startswith("res_finetune.")}
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    assert set(ga) == set(gb) and gb
    floor = 1e-2 * max(g.abs().max().item() for g in gb.values())
    for n, want in gb.items():
        err = (ga[n] - want).abs().max().item()
        assert err <= 2e-3 * max(want.abs().max().item(), floor), n


def test_flash_attn_fwd_at_the_finegym_chunk_matches_plain(cuda):
    """#1 at fg99_mvf.yml's eval chunk (2000 frames x 6 LSTP tokens: (1, 8,
    12000, 32), unmasked), the longest sequence any path gives it, against
    `attention_reference` in fp32 (4.6 GB of scores); fp32 and bf16 as
    TOL states; a second launch bit for bit."""
    g = torch.Generator().manual_seed(1)
    shape = (1, 8, 12000, 32)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for _ in range(3))
        out, lse = attention.flash_attention_fwd(q, k, v, None, 32 ** -0.5)
        again = attention.flash_attention_fwd(q, k, v, None, 32 ** -0.5)
        ref, ref_lse = attention.attention_reference(q.float(), k.float(), v.float(),
                                                     None, 32 ** -0.5)
        out_tol, lse_tol = TOL[dtype]
        assert (out.float() - ref).abs().max().item() <= out_tol
        assert (lse - ref_lse).abs().max().item() <= lse_tol
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del ref, ref_lse
        torch.cuda.empty_cache()


def _tiny_late_vit(monkeypatch, late_type):
    """A late-fusion config over a 2-block test ViT (128-d in 4 heads, patch
    8 at 32 px: widths the GEMM kernel takes), fp32: LATE_TYPE cls, or
    spatial over taps 0 and 1, average pooled."""
    from video_rep_learning_tpu_torch.config import get_cfg
    from video_rep_learning_tpu_torch.models import vit

    monkeypatch.setitem(vit.VIT_SPECS, "vit_cuda_late", vit.ViTSpec(128, 2, 4, 8, img_size=32))
    cfg = get_cfg()
    cfg.USE_AMP, cfg.IMAGE_SIZE, cfg.TRAIN.NUM_FRAMES = False, 32, 12
    cfg.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_cuda_late"
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 8
    e = cfg.MODEL.EMBEDDER_MODEL
    e.FUSION_TYPE, e.LATE_TYPE, e.SMART_FEATS = "late", late_type, "0,1"
    e.FLATTEN_METHOD = "avg_pool" if late_type == "spatial" else "max_pool"
    e.NUM_LAYERS, e.HIDDEN_SIZE, e.NUM_HEADS, e.D_FF = 2, 64, 2, 64
    e.FC_LAYERS, e.CAPACITY_SCALAR, e.EMBEDDING_SIZE = [[32, True]], 1, 16
    return cfg


@pytest.mark.parametrize("late_type", ["cls", "spatial"])
def test_late_vit_embeddings_match_cpu(cuda, monkeypatch, late_type):
    """Late fusion over a small ViT, fp32 (TF32 off): 12 frames of 32 px on
    the card through the ViT kernels and #1 give the CPU's unit-norm
    embeddings within 1e-4 (chip_smoke.py holds the full-width ViT-B/8 at
    CARD_VS_CPU_TOL)."""
    from video_rep_learning_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny_late_vit(monkeypatch, late_type)
    x = torch.rand(1, 12, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(0)
        model = build_model(cfg, dev)
        before = (attention.flash_attention_fwd.launches,
                  vit_block.vit_attention_block.launches)
        with torch.inference_mode():
            out[dev] = model(x.to(dev), 12).cpu()
        launched = (attention.flash_attention_fwd.launches - before[0],
                    vit_block.vit_attention_block.launches - before[1])
        # 2 encoder layers; 2 blocks x 2 chunks of the ViT
        assert launched == ((2, 4) if dev == "cuda" else (0, 0))
    assert out["cuda"].shape == (1, 12, 16)
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4


def test_finegym_probe_matches_cpu(cuda, tmp_path):
    """The FineGym probe (SGD momentum, cosine LR, 10-video batches) on the
    card against the CPU from the same initial weights, fp32, TF32 off:
    equal accuracy, weights within 1e-5 of their largest value."""
    import pickle

    import numpy as np

    from video_rep_learning_tpu_torch.config import get_cfg
    from video_rep_learning_tpu_torch.evaluation import finegym

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    centers = rng.randn(5, 16)
    files = {}
    for split, n in (("train", 20), ("val", 6)):
        files[split] = []
        for i in range(n):
            labels = rng.randint(-1, 5, rng.randint(20, 60))
            embs = (centers[labels] + rng.randn(len(labels), 16)).astype(np.float32)
            path = str(tmp_path / f"{split}_{i}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"embs": embs, "labels": labels, "name": f"{split}_{i}"}, f)
            files[split].append(path)
    cfg = get_cfg()
    cfg.EVAL.CLASS_NUM, cfg.EVAL.CLASSIFICATION_LR, cfg.EVAL.CLASSIFICATION_EPOCHS = 5, 1.0, 5
    cfg.MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE = 16
    init = (rng.uniform(-0.25, 0.25, (5, 16)), rng.uniform(-0.25, 0.25, 5))
    got = {}
    for dev in ("cuda", "cpu"):
        out = {}
        acc = finegym.train_linear_probe(cfg, files["train"], files["val"], 1.0, 0, None,
                                         dev, init=init, probe_out=out)
        assert out["probe"].weight.device.type == dev
        got[dev] = acc, out["probe"].weight.detach().cpu(), out["probe"].bias.detach().cpu()
    assert got["cuda"][0] == got["cpu"][0]
    for a, b in zip(got["cuda"][1:], got["cpu"][1:]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_prefetch_delivers_each_batch_exactly(cuda):
    """DATA.DEVICE_PREFETCH 2 on the card: batches of two sizes (the pinned
    buffers grow once), each read on the compute stream behind a sleep that
    keeps it busy while the worker copies the next ones; every batch arrives
    whole, on the trainer's card, copied on the prefetcher's own stream."""
    import numpy as np

    from video_rep_learning_tpu_torch.train.prefetch import DevicePrefetcher
    from video_rep_learning_tpu_torch.train.trainer import BATCH_KEYS

    rng = np.random.RandomState(0)
    batches = [{"videos": rng.randint(0, 256, (1, 2, 8 + 8 * (i >= 3), 64, 64, 3),
                                      dtype=np.uint8),
                "video_masks": rng.rand(1, 2, 8 + 8 * (i >= 3)).astype(np.float32),
                "dims": np.array([[64.0, 64.0]], np.float32)} for i in range(6)]
    pre = DevicePrefetcher(cuda, 2, BATCH_KEYS, None)
    assert pre.copy_stream != torch.cuda.current_stream()
    sums = []
    for it, host, dev, h2d_s in pre.stream(batches):
        torch.cuda._sleep(20_000_000)  # ~10 ms of a busy compute stream
        assert dev["videos"].device == torch.device("cuda", torch.cuda.current_device())
        sums.append((int(dev["videos"].long().sum()), dev["video_masks"].double().sum()))
        assert "videos" not in host and h2d_s > 0
    for (vs, ms), b in zip(sums, batches):
        assert vs == int(b["videos"].astype(np.int64).sum())
        assert float(ms) == pytest.approx(float(b["video_masks"].astype(np.float64).sum()))
    assert len(pre.h2d_ms()) == 6 and all(t > 0 for t in pre.h2d_ms())
    assert sorted(pre._pinned) == ["video_masks", "videos"]
