"""A tensor-core matrix product in int8 (int32 sums) and bf16 (fp32 sums):
the CUDA kernel, its plain PyTorch version and the wrapper that picks
between them by the device of the tensors.

Counterpart of the TPU micro-benchmark kernel `_mm_kernel`
(`tools/bench_int8_pallas.py:28`, `_pallas_mm`), x (M, K) @ w (K, F) with w
in its (K, F) layout, which asks whether int8 is worth a GEMM of its own for
a quantized ViT backbone; the kernel is `csrc/int8_gemm.cu` (wgmma fed by
TMA; for int8 it first transposes w into a scratch tensor this wrapper
allocates). No model path takes it yet.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version, `tc_matmul_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .plain_grad import use_kernel

M_MULTIPLE, K_MULTIPLE, F_MULTIPLE = 128, 32, 128  # csrc/int8_gemm.cu's tiling
_CODES = {torch.int8: (2, torch.int32), torch.bfloat16: (1, torch.float32)}


def tc_matmul_reference(x, w):
    """x @ w: int8 operands summed exactly (in float64, exact while K *
    127^2 < 2^53) and returned as int32; bf16 operands as an fp32 product of
    their values."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).to(torch.int32)
    return x.float() @ w.float()


def tc_matmul(x, w):
    """x (M, K) @ w (K, F), both int8 (-> int32) or both bf16 (-> fp32). A
    CUDA tensor launches csrc/int8_gemm.cu (M % 128, K % 32, F % 128 == 0)
    or raises, a CPU tensor takes the plain version. `tc_matmul.launches`
    counts kernel launches."""
    if x.dtype not in _CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be int8 or both bf16, got "
                        f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (M, K) and w (K, F), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if not use_kernel("tc_matmul", x, w):
        return tc_matmul_reference(x, w)
    (M, K), Fo = x.shape, w.shape[1]
    if M % M_MULTIPLE or K % K_MULTIPLE or Fo % F_MULTIPLE or 0 in (M, K, Fo):
        raise ValueError(f"the kernel takes M % {M_MULTIPLE}, K % {K_MULTIPLE} "
                         f"and F % {F_MULTIPLE} == 0; got M={M}, K={K}, F={Fo}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on "
                             f"{x.device}")
    code, out_dtype = _CODES[x.dtype]
    out = torch.empty((M, Fo), dtype=out_dtype, device=x.device)
    # int8: w transposed to (F, K) by the kernel's first launch (wgmma reads
    # 8-bit operands K-major only)
    scratch = (torch.empty((Fo, K), dtype=torch.int8, device=x.device)
               if x.dtype == torch.int8 else None)
    fn = cuda_build.kernel_fn("int8_gemm", "vrl_tc_gemm",
                              (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                              + (ctypes.c_void_p,))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), M, K, Fo, code,
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("int8_gemm", err)
    tc_matmul.launches += 1
    return out


tc_matmul.launches = 0
