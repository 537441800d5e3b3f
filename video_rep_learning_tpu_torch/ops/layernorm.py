"""Row LayerNorm: the CUDA kernel, its plain PyTorch version and the wrapper
that picks between them by the device of the tensor.

Counterpart of `video_rep_learning_tpu/ops/layernorm_pallas.py`
(`fused_layernorm`, `_ln_reference`); the kernel is `csrc/layernorm.cu`.
fp32 statistics (the mean, then the centred variance), fp32 scale and bias,
output in the input's type.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version, `layernorm_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layernorm_reference(x, scale, bias, eps=1e-6):
    """LayerNorm over the last dim with fp32 statistics, in x's type."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def check_vector(name, t, n, device):
    """An fp32 (n,) contiguous tensor on `device`, else ValueError."""
    if (t.shape != (n,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous fp32 ({n},) tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def check_activation(name, x):
    """A contiguous fp32 or bf16 tensor of at least one dim, else raise."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be fp32 or bf16, got {x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with a last dim, got "
                         f"{tuple(x.shape)}")


def fused_layernorm(x, scale, bias, eps=1e-6):
    """LayerNorm of x (..., D) with fp32 scale and bias (D,). CUDA tensors go
    through the kernel, CPU tensors through the plain version.
    `fused_layernorm.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return layernorm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm runs on cuda or cpu, not {x.device}")
    check_activation("x", x)
    D = x.shape[-1]
    check_vector("scale", scale, D, x.device)
    check_vector("bias", bias, D, x.device)
    y = torch.empty_like(x)
    rows = x.numel() // max(D, 1)
    if rows == 0:
        return y
    fn = cuda_build.kernel_fn("layernorm", "vrl_layernorm",
                              (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 rows, D, DTYPE_CODES[x.dtype], float(eps),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("layernorm", err)
    fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0
