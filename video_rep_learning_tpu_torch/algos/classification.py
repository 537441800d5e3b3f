"""Supervised per-frame classification, in plain torch.

Counterpart of `video_rep_learning_tpu/algos/classification.py`
(`classification_loss`, `Classification`): in training the cross-entropy
over the frames with a label >= 0, weighted by the video mask; otherwise the
"loss" is the masked accuracy. The mode is the model's (`model.training`),
as `train=` is in the JAX package.

Across processes the JAX package takes one masked mean over the global
batch (its step runs under plain `jit` over the sharded batch). Each rank
here divides its own masked sum by the ranks' summed count, times the world
size: DDP's average of the gradients is then the global mean's gradient, and
the ranks' mean of the returned values is the global mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import all_reduce_tensor, world


def classification_loss(logits, labels, masks, training: bool):
    """logits (B, T, K), labels (B, T) int (-1 = ignore), masks (B, T) ->
    {"loss": 0-d fp32}; with several ranks this rank's share of the global
    masked mean (see the module's docstring)."""
    K = logits.shape[-1]
    logits = logits.reshape(-1, K).float()
    labels = labels.reshape(-1).long()
    masks = masks.reshape(-1).float()
    valid = (labels >= 0).float()
    safe = labels.clamp(min=0)
    if training:
        per = F.cross_entropy(logits, safe, reduction="none")
    else:
        per = (logits.argmax(dim=1) == safe).float()
    w = masks * valid
    size, _ = world()
    if size == 1:
        return {"loss": (per * w).sum() / w.sum()}
    return {"loss": size * (per * w).sum() / all_reduce_tensor(w.sum())}


class Classification:
    """Algo driver (`algos/classification.py:30-49` of the JAX package)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def compute_loss(self, model, batch, backbone_warmup_active=False):
        """batch: videos (B, T(*ctx), S, S, 3) augmented, video_masks and
        labels (B, T)."""
        videos = batch["videos"]
        logits = model(videos, self.cfg.TRAIN.NUM_FRAMES,
                       video_masks=batch["video_masks"].reshape(videos.shape[0], 1, -1),
                       classification=True,
                       backbone_warmup_active=backbone_warmup_active)
        return classification_loss(logits, batch["labels"], batch["video_masks"],
                                   training=model.training)
