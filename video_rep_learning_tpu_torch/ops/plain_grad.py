"""Gradients through the ViT kernels: the kernel's forward, the plain
version's backward, recomputed chunk by chunk.

Counterpart of the JAX package's `jax.custom_vjp`s around its ViT kernels
(`vit_block_pallas.py:282`, `attention_pallas.py:572`,
`matmul_gelu_pallas.py:148`, `:282`, `:430`, `layernorm_pallas.py:77`):
each forward runs the Pallas kernel and keeps only its inputs, each backward
is `jax.vjp` of the plain composition. Here the same, as one
`torch.autograd.Function`:

- forward: the wrapper's no-grad path (the kernel on a CUDA tensor, the
  plain version on a CPU one), saving only the inputs;
- backward: the plain version under autograd, recomputed over chunks of
  `chunk` items of the leading (frame) dim of the batched inputs; their
  gradients are concatenated, the other inputs' (weights, biases, LN
  parameters) summed over the chunks in fp32 and returned in their type.

Frames are independent in every one of these functions, so the chunks give
the whole gradient. They bound the backward's memory: the trainable ViT
tail runs on all 480 frames of a step, where one dense attention backward
would hold (480, 12, 785, 785) fp32 scores (14.2 GB each); at 40 frames a
chunk one is 1.18 GB.

A kernel launch drops any gradient (the kernels write into fresh tensors
through ctypes), so every launching wrapper calls `refuse_grad` first: a
launch outside this Function with grad enabled and an input that requires
grad raises instead of training nothing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def needs_grad(*args) -> bool:
    """Grad mode is on and a tensor among `args` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def refuse_grad(name: str, *args) -> None:
    """Raise if a kernel launch would drop a gradient: the caller must go
    through `with_plain_grad`."""
    if needs_grad(*args):
        raise RuntimeError(
            f"{name}: an input requires grad and grad mode is on, but the "
            "kernel records no gradient; call it through its differentiable "
            "wrapper")


def use_kernel(name: str, x, *inputs) -> bool:
    """True for a CUDA tensor (after `refuse_grad` on `x` and `inputs`),
    False for a CPU one, whose caller takes the plain version; raises on any
    other device."""
    if x.device.type == "cpu":
        return False
    refuse_grad(name, x, *inputs)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


class _ChunkedPlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward_fn, plain_fn, chunk, batched, *args):
        ctx.plain_fn, ctx.chunk, ctx.batched = plain_fn, chunk, batched
        ctx.slots = [isinstance(a, torch.Tensor) for a in args]
        ctx.consts = [None if s else a for s, a in zip(ctx.slots, args)]
        ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)))
        return forward_fn(*args)

    @staticmethod
    def backward(ctx, grad_out):
        saved = iter(ctx.saved_tensors)
        args = [next(saved) if s else c for s, c in zip(ctx.slots, ctx.consts)]
        need = [i for i in range(len(args)) if ctx.needs_input_grad[4 + i]]
        n = grad_out.shape[0]
        step = ctx.chunk or n
        parts = {i: [] for i in need if i in ctx.batched}
        sums = {}
        for s in range(0, max(n, 1), step):
            with torch.enable_grad():
                inputs = list(args)
                for i in ctx.batched:
                    if isinstance(args[i], torch.Tensor):
                        inputs[i] = args[i][s:s + step]
                for i in need:
                    inputs[i] = inputs[i].detach().requires_grad_()
                out = ctx.plain_fn(*inputs)
                grads = torch.autograd.grad(out, [inputs[i] for i in need],
                                            grad_out[s:s + step], allow_unused=True)
            for i, g in zip(need, grads):
                if g is None:
                    g = torch.zeros_like(inputs[i])
                if i in parts:
                    parts[i].append(g)
                else:
                    sums[i] = g.float() if i not in sums else sums[i] + g.float()
        result = [None] * len(args)
        for i in need:
            result[i] = (torch.cat(parts[i]) if i in parts
                         else sums[i].to(args[i].dtype))
        return (None, None, None, None, *result)


def with_plain_grad(forward_fn: Callable, plain_fn: Callable, args: Sequence,
                    batched: Sequence[int], chunk: Optional[int] = None):
    """`forward_fn(*args)`, differentiable through `plain_fn` (the same
    function in plain torch) when grad mode is on and a tensor of `args`
    requires grad; `batched` are the positions of `args` split along dim 0
    in the backward, `chunk` the items a backward chunk (None: all)."""
    if needs_grad(*args):
        return _ChunkedPlainGrad.apply(forward_fn, plain_fn, chunk,
                                       tuple(batched), *args)
    return forward_fn(*args)
