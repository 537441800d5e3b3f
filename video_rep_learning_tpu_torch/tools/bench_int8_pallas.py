"""int8 x int8 -> int32 against bf16 x bf16 -> fp32 at the ViT-B/8 fc1
shape of a 40-frame chunk, (31360, 768) x (768, 3072), as the TPU script
`tools/bench_int8_pallas.py` times them, on the H100: the port's tensor-core
GEMM `tc_matmul` (csrc/int8_gemm.cu, the counterpart of `_mm_kernel`) in
both types, against its plain versions, beside the library calls
(`torch._int_mm` for int8, given w column-major as cuBLASLt takes it, made
before the timing, where tc_matmul's time includes transposing w (K, F),
since wgmma reads 8-bit operands K-major only; `torch.matmul` in bf16,
whose output rounds to bf16) and the bounds. The
question it answers: is int8 worth a GEMM of its own for a quantized ViT
backbone? The TPU script's chained `fori_loop` is not carried over: CUDA
events time the launches themselves.

    python -m video_rep_learning_tpu_torch.tools.bench_int8_pallas [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bounds
from ..ops.int8_matmul import tc_matmul, tc_matmul_reference
from . import common

M, K, FO = 31360, 768, 3072
CPU_SHAPES = dict(M=128, K=64, F=256)
# int8: exact int32 sums on both sides. bf16: the products of bf16 values are
# exact in fp32, summed in another order over K = 768: ~1e-6 of the largest
# value, held at 1e-5
BF16_REL_TOL = 1e-5


def run(device="cuda", M=M, K=K, F=FO, reps=20):
    dev = common.resolve_device(device)
    rng = np.random.RandomState(0)
    xi = torch.from_numpy(rng.randint(-127, 128, (M, K)).astype(np.int8)).to(dev)
    wi = torch.from_numpy(rng.randint(-127, 128, (K, F)).astype(np.int8)).to(dev)
    xb = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev, torch.bfloat16)
    wb = torch.from_numpy((rng.randn(K, F) * 0.03).astype(np.float32)).to(
        dev, torch.bfloat16)
    cuda = dev.type == "cuda"
    wi_cm = wi.t().contiguous().t() if cuda else None  # column-major for _int_mm
    rows = []
    for name, x, w, tol_of, library, lib_what, unit in (
            ("int8 (tc_matmul)", xi, wi, lambda want: 0.0,
             (lambda: torch._int_mm(xi, wi_cm)) if cuda else None,
             "torch._int_mm, w column-major made untimed", "Tops"),
            ("bf16 (tc_matmul)", xb, wb,
             lambda want: BF16_REL_TOL * want.abs().max().item(),
             (lambda: torch.matmul(xb, wb)) if cuda else None,
             "torch.matmul, bf16 out", "TFLOP/s")):
        want = tc_matmul_reference(x, w)
        rows.append(common.row(
            name, dev, tc_matmul(x, w), want, tol_of(want),
            bounds.tc_matmul(M, K, F, x.element_size()),
            what=f"({M}, {K}) x ({K}, {F}) {str(x.dtype)[6:]}",
            kernel=lambda x=x, w=w: tc_matmul(x, w),
            plain=lambda x=x, w=w: tc_matmul_reference(x, w), library=library,
            library_what=lib_what, reps=reps, rate_unit=unit))
        del want
    return rows


if __name__ == "__main__":
    common.main(run, __doc__.splitlines()[0], CPU_SHAPES)
