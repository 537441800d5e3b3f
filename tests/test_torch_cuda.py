"""The hand-written CUDA kernels against their plain PyTorch versions. These
need a CUDA card and skip elsewhere; on the GPU machine run

    python -m pytest -m cuda tests/test_torch_cuda.py

(`chip_smoke.py` makes the same comparisons at the CARL shapes)."""

import pytest
import torch

from video_rep_learning_tpu_torch.ops import attention

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


def test_flash_attn_fwd_rejects_grad_and_bad_head_width(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        attention.flash_attention(q, q, q)
    x = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        attention.flash_attention(x, x, x)
