"""Flash attention, forward and backward, and the ViT's packed-qkv
attention: the CUDA kernels, their plain PyTorch versions and the wrappers
that pick between them by the device of the tensors.

Counterpart of `video_rep_learning_tpu/ops/attention_pallas.py`
(`flash_attention`, `mha_with_flash`, `_attention_reference`, the fused
backward). The kernels are `csrc/flash_attn_fwd.cu` and
`csrc/flash_attn_bwd.cu`, built with nvcc at first use (`ops/cuda_build.py`).
`flash_attention` is differentiable: `FlashAttention` runs the forward kernel,
saves its output and LSE, and its backward runs the backward kernel.
`packed_vit_attention` is the counterpart of that module's
`packed_vit_attention` (`_packed_kernel`); its kernel is
`csrc/packed_attn.cu`, and its backward, as the JAX package's custom_vjp
(`attention_pallas.py:572`), is autograd of the plain version chunked over
frames (`ops/plain_grad.py`).

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version (`attention_reference`,
  `attention_backward_reference`), the same math in plain torch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build
from .plain_grad import refuse_grad, use_kernel, with_plain_grad

NEG_INF = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, kv_mask=None, sm_scale=1.0):
    """softmax(q k^T * sm_scale) v with a per-key mask, and the row
    log-sum-exp. q (B, H, Sq, d), k and v (B, H, Sk, d), kv_mask (B, Sk)
    nonzero = attend. Scores and the softmax are fp32 whatever the input type;
    the output takes q's type, the LSE is fp32 (B, H, Sq)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] != 0, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def attention_backward_reference(q, k, v, kv_mask, out, lse, grad_out,
                                 sm_scale=1.0):
    """(dq, dk, dv) of `attention_reference` recomputed from its LSE, as the
    JAX package's fused backward kernel does: p = exp(s - lse), delta =
    rowsum(dO * O), dv = p^T dO, ds = p (dO v^T - delta) sm_scale, dq = ds k,
    dk = ds^T q. Masked keys score NEG_INF, so a fully masked row keeps its
    p; with bf16 inputs p and ds are rounded to bf16 before their products.
    Sums are fp32; the gradients take the inputs' type."""
    dt = q.dtype
    qf, kf, vf, g = q.float(), k.float(), v.float(), grad_out.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] != 0, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (g * out.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, vf)
    ds = (p * (dp - delta) * sm_scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda_inputs(q, k, v, kv_mask):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be fp32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,Sq,d), k = v (B,H,Sk,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if k.shape[2] < 1:
        raise ValueError("flash_attention needs at least one key")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kv_mask is not None and (kv_mask.shape != (B, k.shape[2])
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be (B, Sk) = {(B, k.shape[2])} on "
                         f"{q.device}, got {tuple(kv_mask.shape)} on "
                         f"{kv_mask.device}")


@functools.lru_cache(maxsize=None)
def _library(name):
    lib = cuda_build.load(name)
    fn = getattr(lib, "vrl_" + name)
    n_ptr = 6 if name == "flash_attn_fwd" else 11
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vrl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vrl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, kv_mask=None, sm_scale=1.0):
    """(out, lse) of masked attention; see `attention_reference` for the
    math. CUDA tensors go through the kernel, CPU tensors through the plain
    version. On CUDA it records no gradient: `flash_attention` is the
    differentiable entry. `flash_attention_fwd.launches` counts kernel
    launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    refuse_grad("flash_attention_fwd", q, k, v)
    _check_cuda_inputs(q, k, v, kv_mask)
    B, H, Sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    if Sq == 0:
        return out, lse
    lib = _library("flash_attn_fwd")
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = lib.vrl_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Sq, k.shape[2], d, _DTYPE_CODES[q.dtype],
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attn_fwd launch failed: "
                           + lib.vrl_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, kv_mask, out, lse, grad_out, sm_scale=1.0):
    """(dq, dk, dv) from the forward's `out` and `lse`; see
    `attention_backward_reference` for the math. CUDA tensors go through the
    kernel, CPU tensors through the plain version.
    `flash_attention_bwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, kv_mask, out, lse,
                                            grad_out, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda_inputs(q, k, v, kv_mask)
    B, H, Sq, d = q.shape
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("grad_out", grad_out, q.shape, q.dtype),
                                  ("lse", lse, (B, H, Sq), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {tuple(shape)} {dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    lib = _library("flash_attn_bwd")
    with torch.cuda.device(q.device):
        err = lib.vrl_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2], d,
            _DTYPE_CODES[q.dtype], float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attn_bwd launch failed: "
                           + lib.vrl_cuda_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel (saving out and
    LSE), the backward kernel; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse,
                                         grad_out.contiguous(), ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_mask=None, sm_scale=1.0):
    """softmax(q k^T * sm_scale) v with an optional per-key mask (B, Sk);
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_mask, sm_scale)
    return flash_attention_fwd(q, k, v, kv_mask, sm_scale)[0]


def mha_with_flash(q, k, v, kv_mask=None):
    """Scaled-dot-product attention with scale 1/sqrt(d)."""
    return flash_attention(q, k, v, kv_mask, 1.0 / math.sqrt(q.shape[-1]))


def packed_attention_reference(qkv, num_heads):
    """Multi-head self-attention of the packed (B, N, 3D) projection [q; k;
    v] (timm's layout), scale 1/sqrt(dh), returned as (B, N, D) in qkv's
    type: `attention_reference` on the split heads."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    dh = D // num_heads

    def heads(t):
        return t.reshape(B, N, num_heads, dh).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    out, _ = attention_reference(q, k, v, None, dh ** -0.5)
    return out.transpose(1, 2).reshape(B, N, D)


def _packed_vit_attention(qkv, num_heads):
    if not use_kernel("packed_vit_attention", qkv):
        return packed_attention_reference(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv must be fp32 or bf16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads) or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (B, N, 3 * {num_heads} * dh) "
                         f"tensor, got {tuple(qkv.shape)}")
    B, N, three_d = qkv.shape
    D = three_d // 3
    dh = D // num_heads
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if B > 65535 or num_heads > 65535:
        raise ValueError(f"grid too large: B={B}, heads={num_heads}")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    fn = cuda_build.kernel_fn("packed_attn", "vrl_packed_attn",
                              (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), out.data_ptr(), B, num_heads, N, dh,
                 _DTYPE_CODES[qkv.dtype], float(dh ** -0.5),
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check_launch("packed_attn", err)
    packed_vit_attention.launches += 1
    return out


def packed_vit_attention(qkv, num_heads, grad_chunk=None):
    """Self-attention straight from the packed (B, N, 3D) qkv, returning
    (B, N, D); see `packed_attention_reference` for the math. CUDA tensors go
    through the kernel (no head transposes, no copies), CPU tensors through
    the plain version. `packed_vit_attention.launches` counts kernel
    launches."""
    return with_plain_grad(_packed_vit_attention, packed_attention_reference,
                           (qkv, num_heads), batched=(0,), chunk=grad_chunk)


packed_vit_attention.launches = 0
