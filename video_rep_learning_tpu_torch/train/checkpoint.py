"""Epoch and mid-epoch checkpoints, and auto-resume.

Counterpart of `video_rep_learning_tpu/train/checkpoint.py` (orbax there):
every SAVE_INTERVAL epochs (and after the last) the trainer writes
`LOGDIR/checkpoints/checkpoint_epoch_%05d.pth` = {epoch, model_state in the
reference state-dict layout (what `models/weights.py` loads; a partially
frozen ViT's back end under `res_finetune.*`, a late-cls ViT under
`backbone.*`), optimizer_state, config}, and a run resumes from the newest
one at the next epoch (`models/__init__.py:17-48`).

With CHECKPOINT.SAVE_EVERY_N_ITERS n > 0 the trainer also writes
`checkpoint_iter_%05d_%07d.pth` (epoch, next iteration) every n steps, the
same state dict. Only the newest is kept, and an epoch save removes them all.
`resume(..., include_mid=True)` starts from whichever checkpoint is furthest
along. A mid file's name does not match the epoch pattern, so the
evaluation CLI (`models/weights.py::load_checkpoint`) sees epoch
checkpoints only.

Across processes only rank 0 writes (the ranks' states are equal); the
writers return the path it writes on every rank.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from ..logging_utils import get_logger
from ..models.weights import latest_checkpoint, load_model_state, reference_state
from ..parallel import is_root_proc

logger = get_logger(__name__)

_MID_RE = re.compile(r"^checkpoint_iter_(\d+)_(\d+)\.pth$")


def checkpoint_dir(logdir: str) -> str:
    return os.path.join(logdir, "checkpoints")


def mid_checkpoints(logdir: str):
    """[(epoch, next_iter, path)] of the mid-epoch checkpoints of `logdir`."""
    d = checkpoint_dir(logdir)
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        m = _MID_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), os.path.join(d, name)))
    return out


def _prune_mid_checkpoints(logdir: str, keep_path: Optional[str] = None):
    for _, _, path in mid_checkpoints(logdir):
        if path != keep_path:
            os.remove(path)


def _write(path: str, model, optimizer, epoch: int, cfg=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"epoch": int(epoch), "model_state": reference_state(model),
             "optimizer_state": optimizer.state_dict()}
    if cfg is not None:
        state["cfg"] = cfg.to_plain()
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a crash mid-write never leaves a truncated newest file


def save_checkpoint(logdir: str, model, optimizer, epoch: int, cfg=None) -> str:
    """The epoch checkpoint; it obsoletes every mid-epoch one."""
    path = os.path.join(checkpoint_dir(logdir), f"checkpoint_epoch_{epoch:05d}.pth")
    if not is_root_proc():
        return path
    _write(path, model, optimizer, epoch, cfg)
    _prune_mid_checkpoints(logdir)
    logger.info("Saving epoch %d to: %s", epoch, path)
    return path


def save_mid_checkpoint(logdir: str, model, optimizer, epoch: int, next_iter: int,
                        cfg=None) -> str:
    """The mid-epoch checkpoint after `next_iter` steps of `epoch`; the older
    mid checkpoints go."""
    path = os.path.join(checkpoint_dir(logdir),
                        f"checkpoint_iter_{epoch:05d}_{next_iter:07d}.pth")
    if not is_root_proc():
        return path
    _write(path, model, optimizer, epoch, cfg)
    _prune_mid_checkpoints(logdir, keep_path=path)
    logger.info("Saving mid-epoch checkpoint (epoch %d, iter %d) to: %s",
                epoch, next_iter, path)
    return path


def resume(logdir: str, model, optimizer,
           include_mid: bool = True) -> Optional[Tuple[int, int]]:
    """Load the checkpoint of `logdir` that is furthest along (model strictly,
    and the optimizer state) and return (epoch, iteration) to start at: an
    epoch-e checkpoint resumes at (e + 1, 0), a mid-epoch one at its own
    (epoch, next_iter). None when there is none; `include_mid=False` reads
    epoch checkpoints only."""
    candidates = []
    path, epoch = latest_checkpoint(logdir)
    if path is not None:
        candidates.append(((epoch + 1, 0), path))
    if include_mid:
        candidates += [((e, it), p) for e, it, p in mid_checkpoints(logdir)]
    if not candidates:
        return None
    (epoch, it), path = max(candidates, key=lambda c: c[0])
    # written by this project's trainer: it pickles the config beside the
    # weights, hence weights_only=False
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_model_state(model, ckpt["model_state"])
    if "optimizer_state" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer_state"])
    logger.info("Loading checkpoint from: %s (resuming at epoch %d, iter %d)",
                path, epoch, it)
    return epoch, it
