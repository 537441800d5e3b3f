"""The hand-written CUDA kernels (flash-attention forward and backward, the
SSL crop+photometric and photometric kernels) against their plain PyTorch
versions. These
need a CUDA card and skip elsewhere; on the GPU machine run

    python -m pytest -m cuda tests/test_torch_cuda.py

(`chip_smoke.py` makes the same comparisons at the CARL shapes)."""

import pytest
import torch

from video_rep_learning_tpu_torch.ops import attention, photometric

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
