"""LayerNorm + matmul + bias + activation (+ residual): the CUDA kernel, its
plain PyTorch version and the wrapper that picks between them by the device
of the tensors.

Counterpart of the LN-prologue part of
`video_rep_learning_tpu/ops/matmul_gelu_pallas.py` (`ln_matmul_bias_act`,
`_reference_ln`, `_ln_rows`, `_gelu_exact`, `_gelu_tanh`); the kernel is
`csrc/ln_gemm.cu`. The weight is nn.Linear's (out, in) matrix, in the
activation's type; the LN parameters and the bias are fp32. The rounding
points are the TPU kernel's: the LN output is rounded to the compute type
before the product, the product accumulates in fp32, the epilogue (bias,
activation, residual) is fp32 and rounds once.

The same kernel with the LN off (`ln_scale=None`) and a residual computes
the ViT attention half-block's projection (`ops/vit_block.py`).

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version, `ln_matmul_bias_act_reference`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .layernorm import (DTYPE_CODES, check_activation, check_vector,
                        layernorm_reference)

ACTIVATIONS = {"none": 0, "gelu_exact": 1, "gelu_tanh": 2}
K_MULTIPLE, F_MULTIPLE, MAX_K = 32, 128, 1536  # csrc/ln_gemm.cu's tiling
MAX_ROW_BLOCKS = 65535  # the grid's y extent, in blocks of 64 (bf16) or 32 rows


def _activate(y, activation):
    if activation == "gelu_exact":
        return F.gelu(y)
    if activation == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if activation != "none":
        raise ValueError(f"activation {activation!r} not in {sorted(ACTIVATIONS)}")
    return y


def ln_matmul_bias_act_reference(x, ln_scale, ln_bias, w, b,
                                 activation="none", residual=None, eps=1e-6):
    """act(LN(x) @ w.T + b) [+ residual] in x's type: the LN (skipped when
    `ln_scale` is None) rounded to x's type, the product of x-typed operands
    summed in fp32, the epilogue in fp32."""
    a = x if ln_scale is None else layernorm_reference(x, ln_scale, ln_bias, eps)
    y = torch.matmul(a.float(), w.to(x.dtype).float().t()) + b.float()
    y = _activate(y, activation)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _check_cuda_inputs(x, ln_scale, ln_bias, w, b, activation, residual):
    check_activation("x", x)
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {sorted(ACTIVATIONS)}")
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != K:
        raise ValueError(f"w must be (F, {K}), got {tuple(w.shape)}")
    Fo = w.shape[0]
    if K % K_MULTIPLE or K > MAX_K or Fo % F_MULTIPLE or Fo == 0:
        raise ValueError(f"the kernel takes K % {K_MULTIPLE} == 0, K <= {MAX_K} "
                         f"and F % {F_MULTIPLE} == 0; got K={K}, F={Fo}")
    if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous {x.dtype} on {x.device}, got "
                         f"{w.dtype} on {w.device}")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    check_vector("b", b, Fo, x.device)
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("give both ln_scale and ln_bias, or neither")
    if ln_scale is not None:
        check_vector("ln_scale", ln_scale, K, x.device)
        check_vector("ln_bias", ln_bias, K, x.device)
    out_shape = x.shape[:-1] + (Fo,)
    if residual is not None and (residual.shape != out_shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"residual must be contiguous {tuple(out_shape)} "
                         f"{x.dtype} on {x.device}, got {tuple(residual.shape)} "
                         f"{residual.dtype} on {residual.device}")
    rows = x.numel() // K
    if -(-rows // (64 if x.dtype == torch.bfloat16 else 32)) > MAX_ROW_BLOCKS:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    return rows, K, Fo, out_shape


def ln_matmul_bias_act(x, ln_scale, ln_bias, w, b, activation="none",
                       residual=None, eps=1e-6):
    """act(LN(x) @ w.T + b) [+ residual] for x (..., K), w (F, K) in x's
    type, fp32 b (F,) and LN parameters (K,) (None: no LN); activation
    "none", "gelu_exact" or "gelu_tanh". CUDA tensors go through the kernel,
    CPU tensors through the plain version. `ln_matmul_bias_act.launches`
    counts kernel launches."""
    if x.device.type == "cpu":
        return ln_matmul_bias_act_reference(x, ln_scale, ln_bias, w, b,
                                            activation, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul_bias_act runs on cuda or cpu, not {x.device}")
    rows, K, Fo, out_shape = _check_cuda_inputs(x, ln_scale, ln_bias, w, b,
                                                activation, residual)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    fn = cuda_build.kernel_fn("ln_gemm", "vrl_ln_gemm",
                              (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(),
                 None if ln_scale is None else ln_scale.data_ptr(),
                 None if ln_bias is None else ln_bias.data_ptr(),
                 w.data_ptr(), b.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), rows, K, Fo, ACTIVATIONS[activation],
                 DTYPE_CODES[x.dtype], float(eps),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("ln_gemm", err)
    ln_matmul_bias_act.launches += 1
    return out


ln_matmul_bias_act.launches = 0
