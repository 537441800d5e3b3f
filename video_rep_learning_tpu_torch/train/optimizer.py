"""Optimizer and per-epoch learning rate.

Counterpart of `video_rep_learning_tpu/train/optimizer.py`, which builds an
optax chain; this one applies the same chain to the trainable parameters in
place (reference `utils/optimizer.py`):
  clip_by_global_norm(GRAD_CLIP): g <- g * c / max(|g|, c), optax's formula
      (not `clip_grad_norm_`'s c / (|g| + 1e-6));
  AdamOptimizer:     g <- g + wd p (coupled L2), then Adam;
  MomentumOptimizer: g <- g + wd p, then a 0.9 trace (torch SGD momentum);
  AdamWOptimizer:    Adam, then + wd p (decoupled);
  p <- p - lr * update.
Parameters whose gradient is None (the trunk's BN under only_bn, which runs
without grad) take a zero gradient, as in the JAX package. Everything stays
on the device: no value is read back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import ConfigNode

B1, B2, ADAM_EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9


class Optimizer:
    """The optax chain of `make_optimizer` over named parameters."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 cfg: ConfigNode):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.type = cfg.OPTIMIZER.TYPE
        if self.type not in ("AdamOptimizer", "MomentumOptimizer",
                             "AdamWOptimizer"):
            raise NotImplementedError(f"optimizer {self.type}")
        self.wd = float(cfg.OPTIMIZER.WEIGHT_DECAY)
        self.clip = float(cfg.OPTIMIZER.GRAD_CLIP or 0)
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros()
        self.nu = zeros() if self.type != "MomentumOptimizer" else []

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float):
        g = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in self.params]
        if self.clip > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            factor = self.clip / torch.clamp(norm, min=self.clip)
            g = torch._foreach_mul(g, factor)
        if self.type != "AdamWOptimizer":
            g = torch._foreach_add(g, self.params, alpha=self.wd)
        self.count += 1
        if self.type == "MomentumOptimizer":
            torch._foreach_mul_(self.mu, MOMENTUM)
            torch._foreach_add_(self.mu, g)
            update = self.mu
        else:
            torch._foreach_lerp_(self.mu, g, 1.0 - B1)
            torch._foreach_mul_(self.nu, B2)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
            mu_hat = torch._foreach_div(self.mu, 1.0 - B1 ** self.count)
            nu_hat = torch._foreach_div(self.nu, 1.0 - B2 ** self.count)
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS)
            update = torch._foreach_div(mu_hat, denom)
            if self.type == "AdamWOptimizer":
                update = torch._foreach_add(update, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, update, alpha=-lr)

    def state_dict(self) -> Dict:
        return {"type": self.type, "count": self.count,
                "mu": dict(zip(self.names, (t.detach().cpu() for t in self.mu))),
                "nu": dict(zip(self.names, (t.detach().cpu() for t in self.nu)))}

    def load_state_dict(self, state: Dict):
        if state["type"] != self.type or set(state["mu"]) != set(self.names):
            raise ValueError("optimizer state does not match this optimizer's "
                             "type and parameters")
        self.count = int(state["count"])
        for dst, name in zip(self.mu, self.names):
            dst.copy_(state["mu"][name])
        for dst, name in zip(self.nu, self.names):
            dst.copy_(state["nu"][name])


def learning_rate_for_epoch(cfg: ConfigNode, epoch: int) -> float:
    """LR at a given epoch under the reference's per-epoch stepping
    (`utils/optimizer.py:79-104`; the scheduler is stepped at the end of
    every epoch except the last, `train.py:185-186`)."""
    lr_cfg = cfg.OPTIMIZER.LR
    base = lr_cfg.INITIAL_LR
    decay = lr_cfg.DECAY_TYPE
    max_epochs = cfg.TRAIN.MAX_EPOCHS
    if decay == "fixed":
        return base
    if decay == "cosine":
        t_max = max_epochs + 1
        return base * (1 + math.cos(math.pi * epoch / t_max)) / 2
    if decay == "cosinewarmup":
        warm = lr_cfg.NUM_WARMUP_STEPS
        warmup = np.linspace(lr_cfg.WARMUP_LR / base, 1.0, warm)
        iters = np.arange(max_epochs + 1 - warm)
        final_ratio = lr_cfg.FINAL_LR / base
        cos = final_ratio + 0.5 * (1 - final_ratio) * (
            1 + np.cos(np.pi * iters / len(iters)))
        sched = np.concatenate([warmup, cos])
        return float(base * sched[min(epoch, len(sched) - 1)])
    if decay == "multiply":
        return base * (lr_cfg.DECAY_RATE ** epoch)
    raise NotImplementedError(f"scheduler {decay}")
