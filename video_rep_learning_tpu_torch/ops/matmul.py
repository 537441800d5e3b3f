"""The ViT's fused matmuls: LayerNorm + matmul + bias + activation (+
residual), matmul + bias + GELU, and the whole LN-MLP half-block. The CUDA
kernels, their plain PyTorch versions and the wrappers that pick between
them by the device of the tensors.

Counterpart of `video_rep_learning_tpu/ops/matmul_gelu_pallas.py`:
- `ln_matmul_bias_act` (`_kernel_ln`, #6; plain `_reference_ln`): the
  kernel is `csrc/ln_gemm.cu` (bf16: wgmma on a persistent grid, each 64-row
  panel normalised once; fp32: fp32 FMA). It is also the port of both
  schedules of the TPU micro-benchmark tools/bench_ln_matmul.py;
- `matmul_bias_gelu` (`_kernel`, #7; plain `_reference`): the same
  `csrc/ln_gemm.cu` with the LN off and the erf or tanh GELU epilogue. The
  TPU kernel is that product with that epilogue, so this is its port; it
  counts its own launches;
- `ln_mlp_block` (`_kernel_mlp`, #9; plain `_reference_mlp`): x +
  act(LN(x) W1^T + b1) W2^T + b2 in one launch of `csrc/mlp_block.cu`,
  whose (rows, 4D) activation never reaches device memory.

Weights are nn.Linear's (out, in) matrices, in the activation's type; the
LN parameters and the biases are fp32. The rounding points are the TPU
kernels': the LN output is rounded to the compute type before the product,
the product accumulates in fp32, the epilogue (bias, activation, residual)
is fp32 and rounds once; #9 rounds its activation once more before fc2.

The same GEMM with the LN off and a residual computes the ViT attention
half-block's projection (`ops/vit_block.py`).

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version.
- Each wrapper is differentiable (`ops/plain_grad.py`): with grad on and an
  input that requires grad, the forward is the kernel (or the plain version
  on the CPU) and the backward is autograd of the plain version, chunked
  over `grad_chunk` frames, as the JAX package's custom_vjps are.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .layernorm import (DTYPE_CODES, check_activation, check_vector,
                        layernorm_reference)
from .plain_grad import use_kernel, with_plain_grad

ACTIVATIONS = {"none": 0, "gelu_exact": 1, "gelu_tanh": 2}
K_MULTIPLE, F_MULTIPLE, MAX_K = 32, 128, 1536  # csrc/ln_gemm.cu's tiling
# the fp32 kernel's grid y extent, in blocks of 32 rows (bf16 runs a
# persistent grid)
MAX_ROW_BLOCKS = 65535
# csrc/mlp_block.cu: K (the model width) a multiple of 128 up to 768, F of 64
MLP_K_MULTIPLE, MLP_MAX_K, MLP_F_MULTIPLE = 128, 768, 64


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
    if x.dtype == torch.float32 and -(-rows // 32) > MAX_ROW_BLOCKS:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or (
            residual is not None and residual.data_ptr() % 16)):
        raise ValueError("bf16 x and residual must be 16-byte aligned")
    return rows, K, Fo, out_shape


def _ln_gemm_launch(x, ln_scale, ln_bias, w, b, activation, residual, eps):
    """One launch of csrc/ln_gemm.cu on CUDA tensors (counted by the
    caller)."""
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
    return out


def _ln_matmul_bias_act(x, ln_scale, ln_bias, w, b, activation, residual, eps):
    if not use_kernel("ln_matmul_bias_act", x, ln_scale, ln_bias, w, b, residual):
        return ln_matmul_bias_act_reference(x, ln_scale, ln_bias, w, b,
                                            activation, residual, eps)
    out = _ln_gemm_launch(x, ln_scale, ln_bias, w, b, activation, residual, eps)
    ln_matmul_bias_act.launches += 1
    return out


def ln_matmul_bias_act(x, ln_scale, ln_bias, w, b, activation="none",
                       residual=None, eps=1e-6, grad_chunk=None):
    """act(LN(x) @ w.T + b) [+ residual] for x (..., K), w (F, K) in x's
    type, fp32 b (F,) and LN parameters (K,) (None: no LN); activation
    "none", "gelu_exact" or "gelu_tanh". CUDA tensors go through the kernel,
    CPU tensors through the plain version. `ln_matmul_bias_act.launches`
    counts kernel launches."""
    return with_plain_grad(_ln_matmul_bias_act, ln_matmul_bias_act_reference,
                           (x, ln_scale, ln_bias, w, b, activation, residual, eps),
                           batched=(0, 6), chunk=grad_chunk)


ln_matmul_bias_act.launches = 0


def _gelu_name(approximate):
    return "gelu_tanh" if approximate else "gelu_exact"


def matmul_bias_gelu_reference(x, w, b, approximate=False):
    """gelu(x @ w.T + b) in x's type: x-typed operands summed in fp32, the
    bias and the GELU (tanh with `approximate`, else erf) in fp32, one
    rounding."""
    return ln_matmul_bias_act_reference(x, None, None, w, b,
                                        _gelu_name(approximate))


def _matmul_bias_gelu(x, w, b, approximate):
    if not use_kernel("matmul_bias_gelu", x, w, b):
        return matmul_bias_gelu_reference(x, w, b, approximate)
    out = _ln_gemm_launch(x, None, None, w, b, _gelu_name(approximate), None, 0.0)
    matmul_bias_gelu.launches += 1
    return out


def matmul_bias_gelu(x, w, b, approximate=False, grad_chunk=None):
    """gelu(x @ w.T + b) for x (..., K), w (F, K) in x's type and fp32 b
    (F,), with the erf GELU or (`approximate`) the tanh one: #7. CUDA
    tensors go through csrc/ln_gemm.cu with the LN off, CPU tensors through
    the plain version. `matmul_bias_gelu.launches` counts its launches
    (`ln_matmul_bias_act.launches` does not)."""
    return with_plain_grad(_matmul_bias_gelu, matmul_bias_gelu_reference,
                           (x, w, b, approximate), batched=(0,), chunk=grad_chunk)


matmul_bias_gelu.launches = 0


def ln_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           activation="gelu_exact", eps=1e-6):
    """x + act(LN(x) @ w1.T + b1) @ w2.T + b2 in x's type: the LN rounded
    to x's type, fc1 summed in fp32 with its bias and activation in fp32 and
    rounded once, fc2 summed in fp32 with b2 and x added in fp32 and rounded
    once."""
    h = ln_matmul_bias_act_reference(x, ln_scale, ln_bias, w1, b1, activation, eps=eps)
    return ln_matmul_bias_act_reference(h, None, None, w2, b2, residual=x)


def _check_mlp_inputs(x, ln_scale, ln_bias, w1, b1, w2, b2, activation):
    check_activation("x", x)
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {sorted(ACTIVATIONS)}")
    K = x.shape[-1]
    if w1.dim() != 2 or w1.shape[1] != K or w2.dim() != 2 or w2.shape != (K, w1.shape[0]):
        raise ValueError(f"w1 must be (F, {K}) and w2 ({K}, F), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("a bf16 x must be 16-byte aligned (TMA)")
    Fh = w1.shape[0]
    if K % MLP_K_MULTIPLE or K > MLP_MAX_K or Fh % MLP_F_MULTIPLE or Fh == 0:
        raise ValueError(f"the kernel takes K % {MLP_K_MULTIPLE} == 0, K <= "
                         f"{MLP_MAX_K} and F % {MLP_F_MULTIPLE} == 0; got "
                         f"K={K}, F={Fh}")
    for name, w in (("w1", w1), ("w2", w2)):
        if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
            raise ValueError(f"{name} must be contiguous {x.dtype} on {x.device}, "
                             f"got {w.dtype} on {w.device}")
        if w.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    check_vector("ln_scale", ln_scale, K, x.device)
    check_vector("ln_bias", ln_bias, K, x.device)
    check_vector("b1", b1, Fh, x.device)
    check_vector("b2", b2, K, x.device)
    return x.numel() // K, K, Fh


def _ln_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, eps):
    if not use_kernel("ln_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2):
        return ln_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      activation, eps)
    rows, K, Fh = _check_mlp_inputs(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                    activation)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = cuda_build.kernel_fn("mlp_block", "vrl_mlp_block",
                              (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 out.data_ptr(), rows, K, Fh, ACTIVATIONS[activation],
                 DTYPE_CODES[x.dtype], float(eps),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("mlp_block", err)
    ln_mlp_block.launches += 1
    return out


def ln_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, activation="gelu_exact",
                 eps=1e-6, grad_chunk=None):
    """x + act(LN(x) @ w1.T + b1) @ w2.T + b2 for x (..., K), nn.Linear
    weights w1 (F, K) and w2 (K, F) in x's type, fp32 LN parameters and
    biases: the ViT's MLP half-block, #9. CUDA tensors go through
    csrc/mlp_block.cu, CPU tensors through the plain version.
    `ln_mlp_block.launches` counts kernel launches."""
    return with_plain_grad(_ln_mlp_block, ln_mlp_block_reference,
                           (x, ln_scale, ln_bias, w1, b1, w2, b2, activation, eps),
                           batched=(0,), chunk=grad_chunk)


ln_mlp_block.launches = 0
