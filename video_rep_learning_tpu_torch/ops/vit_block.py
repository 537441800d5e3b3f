"""The ViT attention half-block, y = x + proj(MHA(LN(x))): three launches of
the port's own kernels, and its plain PyTorch version.

Counterpart of `video_rep_learning_tpu/ops/vit_block_pallas.py`
(`vit_attention_block`, `_reference`). The TPU kernel (`_kernel_t`, `_kernel`)
does the whole half-block in one program per image, keeping the (N, 3D)
qkv in VMEM; at 785 tokens x 2304 bf16 that is 3.6 MB a frame, and a Hopper
block has 227 KB of shared memory. So the half-block is composed, with no
library call between:

1. LN1 + qkv: `ln_matmul_bias_act(..., "none")` (`csrc/ln_gemm.cu`), the qkv
   rounded to the compute type as the TPU kernel rounds its scratch;
2. attention: `packed_vit_attention` (`csrc/packed_attn.cu`) on the packed
   qkv, its output rounded to the compute type;
3. proj + bias + residual: the GEMM again, LN off, the residual added in
   fp32 before the one final rounding (`vit_block_pallas.py:166`).

The TPU kernel scales q in bf16 before q k^T by default (`_use_prescale`);
the port scales the fp32 scores, as the JAX module path and `_reference` do.

- CUDA tensors launch the three kernels or raise: there is no fallback.
- CPU tensors take the plain version, `vit_attention_block_reference`.
- Differentiable as one function (`ops/plain_grad.py`): the forward is the
  three launches, the backward autograd of the plain version chunked over
  `grad_chunk` frames, as the JAX package's custom_vjp
  (`vit_block_pallas.py:282`) is the vjp of its `_reference`.
"""

from __future__ import annotations

from .attention import packed_attention_reference, packed_vit_attention
from .matmul import ln_matmul_bias_act, ln_matmul_bias_act_reference
from .plain_grad import use_kernel, with_plain_grad


def vit_attention_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                  bproj, num_heads, eps=1e-6):
    """x + proj(MHA(LN(x))) in x's type, rounding where the kernels do."""
    qkv = ln_matmul_bias_act_reference(x, ln_scale, ln_bias, wqkv, bqkv, eps=eps)
    o = packed_attention_reference(qkv, num_heads)
    return ln_matmul_bias_act_reference(o, None, None, wproj, bproj, residual=x)


def _vit_attention_block(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                         num_heads, eps):
    if not use_kernel("vit_attention_block", x, ln_scale, ln_bias, wqkv, bqkv,
                      wproj, bproj):
        return vit_attention_block_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                             wproj, bproj, num_heads, eps)
    qkv = ln_matmul_bias_act(x, ln_scale, ln_bias, wqkv, bqkv, eps=eps)
    o = packed_vit_attention(qkv, num_heads)
    y = ln_matmul_bias_act(o, None, None, wproj, bproj, residual=x)
    vit_attention_block.launches += 1
    return y


def vit_attention_block(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                        num_heads, eps=1e-6, grad_chunk=None):
    """x (B, N, D) + proj(MHA(LN(x))) with nn.Linear weights wqkv (3D, D) and
    wproj (D, D) in x's type, fp32 biases and LN parameters. CUDA tensors go
    through the kernels, CPU tensors through the plain version.
    `vit_attention_block.launches` counts calls on CUDA (one a half-block);
    each kernel counts its own launches."""
    return with_plain_grad(_vit_attention_block, vit_attention_block_reference,
                           (x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                            num_heads, eps), batched=(0,), chunk=grad_chunk)


vit_attention_block.launches = 0
