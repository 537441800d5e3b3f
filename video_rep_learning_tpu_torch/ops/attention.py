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
`csrc/packed_attn.cu` (bf16 on the tensor cores, in the TPU kernel's
max-free softmax unless VRL_ATTN_MAXSUB=1, read at each call as the JAX
package reads it; fp32 on the CUDA cores), and its backward, as the JAX
package's custom_vjp (`attention_pallas.py:572`), is autograd of the plain
version chunked over frames (`ops/plain_grad.py`).
`packed_attention_variant` computes the same attention in each form the
TPU micro-benchmarks compare (`tools/bench_packed_attn.py`,
`tools/bench_attn_variants.py`: exp2, the max-free softmax, P rounded to
bf16 before its sum, 256-row query tiles, heads and images a block); its
kernel is `csrc/packed_attn_variants.cu` and its plain version,
`packed_attention_variant_reference`, rounds as each variant does. No model
path takes it.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version (`attention_reference`,
  `attention_backward_reference`), the same math in plain torch.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

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


def _check_aligned(kernel, **tensors):
    """The kernels stage their tiles with 16-byte copies (cp.async)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the {kernel} "
                             f"kernel")


@functools.lru_cache(maxsize=None)
def _library(name):
    lib = cuda_build.load(name)
    fn = getattr(lib, "vrl_" + name)
    n_ptr = 6 if name == "flash_attn_fwd" else 10
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vrl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vrl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, kv_mask=None, sm_scale=1.0):
    """(out, lse) of masked attention; see `attention_reference` for the
    math. CUDA tensors go through the kernel (16-byte aligned q, k, v; with
    bf16 inputs it rounds p to bf16 before P V, as the plain version does),
    CPU tensors through the plain version. On CUDA it records no gradient:
    `flash_attention` is the differentiable entry.
    `flash_attention_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    refuse_grad("flash_attention_fwd", q, k, v)
    _check_cuda_inputs(q, k, v, kv_mask)
    _check_aligned("forward", q=q, k=k, v=v)
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
    kernel (one launch; it takes delta = rowsum(dO * O) from `out` itself),
    CPU tensors through the plain version. `flash_attention_bwd.launches`
    counts kernel launches."""
    if not use_kernel("flash_attention_bwd", q):
        return attention_backward_reference(q, k, v, kv_mask, out, lse,
                                            grad_out, sm_scale)
    _check_cuda_inputs(q, k, v, kv_mask)
    B, H, Sq, d = q.shape
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("grad_out", grad_out, q.shape, q.dtype),
                                  ("lse", lse, (B, H, Sq), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {tuple(shape)} {dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    _check_aligned("backward", q=q, k=k, v=v, out=out, grad_out=grad_out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    lib = _library("flash_attn_bwd")
    with torch.cuda.device(q.device):
        err = lib.vrl_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Sq, k.shape[2], d, _DTYPE_CODES[q.dtype],
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
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


def attention_maxsub():
    """The JAX package's switch (`attention_pallas._use_maxsub`), read when
    called: VRL_ATTN_MAXSUB=1 takes the max-subtracted softmax in the bf16
    kernel, anything else the TPU kernel's max-free one."""
    return os.environ.get("VRL_ATTN_MAXSUB", "0") == "1"


def packed_attn_args(qkv, out, num_heads):
    """The arguments of csrc/packed_attn.cu's `vrl_packed_attn` after the
    stream: qkv and out pointers, B, heads, N, dh, the dtype code, the
    softmax form (`attention_maxsub()` at this call) and the scale."""
    B, N, three_d = qkv.shape
    dh = three_d // 3 // num_heads
    return (qkv.data_ptr(), out.data_ptr(), B, num_heads, N, dh,
            _DTYPE_CODES[qkv.dtype], int(attention_maxsub()), float(dh ** -0.5))


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
    if qkv.data_ptr() % 16:  # the bf16 kernel's TMA tensor map
        raise ValueError("qkv must be 16-byte aligned")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    fn = cuda_build.kernel_fn("packed_attn", "vrl_packed_attn",
                              (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(qkv.device):
        err = fn(*packed_attn_args(qkv, out, num_heads),
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check_launch("packed_attn", err)
    packed_vit_attention.launches += 1
    return out


def packed_vit_attention(qkv, num_heads, grad_chunk=None):
    """Self-attention straight from the packed (B, N, 3D) qkv, returning
    (B, N, D); see `packed_attention_reference` for the math (the bf16
    kernel's max-free softmax is the same function for logits within its
    clamp; `attention_maxsub`). CUDA tensors go through the kernel (no head
    transposes, no copies), CPU tensors through the plain version.
    `packed_vit_attention.launches` counts kernel launches."""
    return with_plain_grad(_packed_vit_attention, packed_attention_reference,
                           (qkv, num_heads), batched=(0,), chunk=grad_chunk)


packed_vit_attention.launches = 0


LOG2E = 1.4426950408889634
VARIANT_HEAD_DIM = 64  # csrc/packed_attn_variants.cu's head width
VARIANT_BLOCK_Q = (64, 256)
PLAIN_CHUNK = 40  # images a plain-version pass: (40, H, N, N) fp32 scores


def variant_scale(dh, exp2):
    """The TPU kernels' logit scale: 1/sqrt(dh), times log2(e) with exp2."""
    return float(1.0 / math.sqrt(dh) * (LOG2E if exp2 else 1.0))


def packed_attention_variant_reference(qkv, num_heads, *, exp2, nomax, bf16p):
    """`packed_attention_reference`'s attention as the TPU variant kernels
    compute it, one-shot over each row: s = (q k^T in fp32) * scale
    (`variant_scale`); p = exp2(min(s, 110)) (exp(min(s, 76)) without exp2)
    with `nomax`, else exp2 or exp of s minus the row max; l sums p, or p
    rounded to qkv's type with `bf16p`; out = (p rounded to qkv's type) v in
    fp32, over l, rounded to qkv's type. PLAIN_CHUNK images at a time bound
    the fp32 scores."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    dh = D // num_heads
    scale = variant_scale(dh, exp2)
    expo = torch.exp2 if exp2 else torch.exp
    outs = []
    for s0 in range(0, B, PLAIN_CHUNK):
        part = qkv[s0:s0 + PLAIN_CHUNK]
        n = part.shape[0]
        q, k, v = (t.reshape(n, N, num_heads, dh).transpose(1, 2).float()
                   for t in part.split(D, dim=-1))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if nomax:
            p = expo(torch.clamp(s, max=110.0 if exp2 else 76.0))
        else:
            p = expo(s - s.amax(-1, keepdim=True))
        del s
        pr = p.to(qkv.dtype).float()
        l = (pr if bf16p else p).sum(-1, keepdim=True)
        del p
        o = torch.einsum("bhqk,bhkd->bhqd", pr, v) / l
        outs.append(o.transpose(1, 2).reshape(n, N, D).to(qkv.dtype))
    return torch.cat(outs)


def packed_attention_variant(qkv, num_heads, *, exp2, nomax, bf16p, block_q=64,
                             heads_per_block=2, images_per_block=1):
    """Self-attention of the packed bf16 (B, N, 3D) qkv in one of the TPU
    micro-benchmarks' forms (see `packed_attention_variant_reference` for
    the math); `block_q` (64 or 256), `heads_per_block` and
    `images_per_block` set the kernel's schedule only. A CUDA tensor
    launches csrc/packed_attn_variants.cu or raises, a CPU tensor takes the
    plain version. It records no gradient.
    `packed_attention_variant.launches` counts kernel launches."""
    flags = dict(exp2=exp2, nomax=nomax, bf16p=bf16p)
    if not use_kernel("packed_attention_variant", qkv):
        return packed_attention_variant_reference(qkv, num_heads, **flags)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv must be bf16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads) or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (B, N, 3 * {num_heads} * dh) "
                         f"tensor, got {tuple(qkv.shape)}")
    B, N, three_d = qkv.shape
    D = three_d // 3
    dh = D // num_heads
    if dh != VARIANT_HEAD_DIM:
        raise ValueError(f"head width {dh} not supported; the kernel takes "
                         f"{VARIANT_HEAD_DIM}")
    if block_q not in VARIANT_BLOCK_Q:
        raise ValueError(f"block_q {block_q} not in {VARIANT_BLOCK_Q}")
    if num_heads % heads_per_block or B % images_per_block:
        raise ValueError(f"heads_per_block {heads_per_block} must divide "
                         f"{num_heads} heads and images_per_block "
                         f"{images_per_block} the {B} images")
    if B // images_per_block > 65535:
        raise ValueError(f"grid too large: B={B}")
    if qkv.data_ptr() % 16:  # the kernel's TMA tensor map
        raise ValueError("qkv must be 16-byte aligned")
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    fn = cuda_build.kernel_fn("packed_attn_variants", "vrl_packed_attn_variant",
                              (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 9
                              + (ctypes.c_float, ctypes.c_void_p))
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), out.data_ptr(), B, num_heads, N, int(exp2),
                 int(nomax), int(bf16p), block_q, heads_per_block,
                 images_per_block, variant_scale(dh, exp2),
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check_launch("packed_attn_variants", err)
    packed_attention_variant.launches += 1
    return out


packed_attention_variant.launches = 0
