"""Epoch checkpoints and auto-resume.

Counterpart of `video_rep_learning_tpu/train/checkpoint.py` (orbax there):
every SAVE_INTERVAL epochs (and after the last) the trainer writes
`LOGDIR/checkpoints/checkpoint_epoch_%05d.pth` = {epoch, model_state in the
reference state-dict layout (what `models/weights.py` loads), optimizer_state,
config}, and a run resumes from the newest one at the next epoch
(`models/__init__.py:17-48`). Mid-epoch checkpoints with exact resume come in
a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..logging_utils import get_logger
from ..models.weights import latest_checkpoint, load_model_state

logger = get_logger(__name__)


def save_checkpoint(logdir: str, model, optimizer, epoch: int, cfg=None) -> str:
    path = os.path.join(logdir, "checkpoints", f"checkpoint_epoch_{epoch:05d}.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"epoch": int(epoch),
             "model_state": {k: v.detach().cpu()
                             for k, v in model.state_dict().items()},
             "optimizer_state": optimizer.state_dict()}
    if cfg is not None:
        state["cfg"] = cfg.to_plain()
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a crash mid-write never leaves a truncated newest file
    logger.info("Saving epoch %d to: %s", epoch, path)
    return path


def resume(logdir: str, model, optimizer) -> Optional[int]:
    """Load the newest epoch checkpoint of `logdir` (model strictly, and the
    optimizer state) and return the epoch to start at, or None when there is
    none."""
    path, epoch = latest_checkpoint(logdir)
    if path is None:
        return None
    # written by this project's trainer: it pickles the config beside the
    # weights, hence weights_only=False
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_model_state(model, ckpt["model_state"])
    epoch = int(ckpt.get("epoch", epoch))
    if "optimizer_state" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer_state"])
    logger.info("Loading checkpoint from: %s (resuming at epoch %d)", path,
                epoch + 1)
    return epoch + 1
