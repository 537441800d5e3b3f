"""Time-Contrastive Network (TCN) n-pairs loss, in plain torch.

Counterpart of `video_rep_learning_tpu/algos/tcn.py` (`tcn_loss`, `TCN`):
the sampler interleaves anchor (even) and positive (odd) frames; per
sequence the loss is the cross-entropy of each anchor's similarities to
every positive against its own, plus 0.25 * REG_LAMBDA times the mean
squared norms of anchors and positives; then the mean over sequences. All
sequences at once, as the JAX package's vmap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tcn_loss(embs, *, reg_lambda: float):
    """embs (B, T, C), anchors at even and positives at odd frames ->
    {"loss": 0-d fp32}."""
    embs = embs.float()
    anchors, positives = embs[:, 0::2], embs[:, 1::2]
    B, n, _ = anchors.shape
    reg = (torch.square(anchors).sum(dim=2).mean(dim=1)
           + torch.square(positives).sum(dim=2).mean(dim=1))
    sim = torch.matmul(anchors, positives.transpose(1, 2))
    labels = torch.arange(n, device=embs.device).repeat(B)
    xent = F.cross_entropy(sim.reshape(B * n, n), labels,
                           reduction="none").view(B, n).mean(dim=1)
    return {"loss": (0.25 * reg_lambda * reg + xent).mean()}


class TCN:
    """Algo driver (`algos/tcn.py:37-56` of the JAX package)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def compute_loss(self, model, batch, backbone_warmup_active=False):
        """batch: videos (B, T(*ctx), S, S, 3) augmented (a two-view
        (B, V, ...) batch is flattened), video_masks (B[, V], T)."""
        videos = batch["videos"]
        if videos.dim() == 6:
            videos = videos.reshape((-1,) + videos.shape[2:])
        embs = model(videos, self.cfg.TRAIN.NUM_FRAMES,
                     video_masks=batch["video_masks"].reshape(videos.shape[0], 1, -1),
                     backbone_warmup_active=backbone_warmup_active)
        return tcn_loss(embs, reg_lambda=self.cfg.TCN.REG_LAMBDA)
