"""Collectives across the ranks of the process group.

Counterpart of `video_rep_learning_tpu/parallel/collectives.py` (the
reference's `utils/distributed.py:136-265`): a ragged gather of pickled
objects, a host scalar summed in fp64, a barrier; each is the identity
with one process. `all_gather_with_grad` gathers a tensor and carries the
gradient back, for the losses' global branches.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

from .mesh import world


def _collective_device():
    """NCCL reduces tensors on the rank's card, gloo on the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj: Any) -> List[Any]:
    """One picklable object a rank, in rank order (pickles of any length)."""
    size, _ = world()
    if size == 1:
        return [obj]
    out: List[Any] = [None] * size
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(value: float) -> float:
    """A host scalar summed over the ranks in fp64 (the FineGym probe's
    counters, the logged losses)."""
    if world()[0] == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    return float(t.item())


def synchronize() -> None:
    """Barrier."""
    if world()[0] == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _GatherWithGrad(torch.autograd.Function):
    """all_gather whose backward hands each rank the gradient of its own
    rows summed over the ranks (each rank's loss reads every rank's rows)."""

    @staticmethod
    def forward(ctx, x):
        size, rank = world()
        ctx.rank = rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x)  # gloo gathers card tensors this way too
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        n = grad.shape[0] // world()[0]
        return grad[ctx.rank * n:(ctx.rank + 1) * n]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated on dim 0 in rank order,
    differentiable: the backward sums over the ranks, so with every rank
    computing the same global loss and DDP averaging, each parameter's
    gradient is the global loss's."""
    if world()[0] == 1:
        return x
    return _GatherWithGrad.apply(x)
