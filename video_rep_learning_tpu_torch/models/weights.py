"""The weight bridge: reference-layout state dicts in and out of the port.

Weights cross between the JAX package and this one in the reference
`TransformerModel` state-dict layout. The JAX package turns its variables
into that layout (`models/import_torch.py::convert_to_carl_state_dict` for
CARL, `convert_to_mvf_state_dict` for MV-Former: the timm ViT under
`backbone.model.*`, the head under `embed.pooling.cross_att.*`,
`embed.fc_layers.*`, `embed.video_emb`, `embed.video_encoder.*`,
`embed.embedding_layer`, `ssl_projection.net.*`; numpy arrays) and writes it
as `LOGDIR/checkpoints/checkpoint_epoch_%05d.pth` (`export_carl_checkpoint`,
`export_mvf_checkpoint`, `tools/export_torch_checkpoint.py`); the port loads
either with `load_state_dict(strict=True)`.

A partially frozen ViT (LAYER = L below the depth) keeps the front's
`backbone.model.{patch_embed, cls_token, pos_embed, blocks.0..L-1}` and
moves blocks L.. and the final norm into the trainable back end,
`res_finetune.blocks.{i}` (global i, timm names) and `res_finetune.norm`,
so `set_trainable` trains them with no rule of their own. The reference
layout has every block under `backbone.model`: `split_vit_state` maps it
onto the partial model, and `load_model_state` does so for a dict with no
`res_finetune.*` key (a warm start from a fully frozen MV-Former `.pth`).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict

import numpy as np
import torch

_CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.pth$")


def state_dict_from_numpy(sd) -> Dict[str, torch.Tensor]:
    """The numpy reference-layout dict -> torch tensors (copies)."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def latest_checkpoint(logdir: str):
    """(path, epoch) of the newest `LOGDIR/checkpoints/checkpoint_epoch_*.pth`,
    or (None, -1) when there is none."""
    best, best_epoch = None, -1
    for path in glob.glob(os.path.join(logdir, "checkpoints",
                                       "checkpoint_epoch_*.pth")):
        m = _CKPT_RE.search(path)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = path, int(m.group(1))
    return best, best_epoch


def load_checkpoint(model: torch.nn.Module, logdir: str) -> int:
    """Load the newest epoch checkpoint of `logdir` into `model` strictly and
    return its epoch. The file is one this project's trainer or exporter
    wrote: it pickles the run's config beside the weights, so it is loaded
    with `weights_only=False`."""
    path, epoch = latest_checkpoint(logdir)
    if path is None:
        raise FileNotFoundError(
            f"no checkpoint_epoch_*.pth under {os.path.join(logdir, 'checkpoints')}")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_model_state(model, ckpt["model_state"])
    return int(ckpt.get("epoch", epoch))


_BLOCK_RE = re.compile(r"^backbone\.model\.blocks\.(\d+)\.(.*)$")


def split_vit_state(sd, num_front_blocks: int):
    """A reference-layout state dict with the whole ViT under
    `backbone.model.*` -> the partially frozen layout: blocks i >= L to
    `res_finetune.blocks.{i}.*`, the final norm to `res_finetune.norm.*`;
    everything else as it was."""
    out = {}
    for k, v in sd.items():
        m = _BLOCK_RE.match(k)
        if m and int(m.group(1)) >= num_front_blocks:
            k = f"res_finetune.blocks.{m.group(1)}.{m.group(2)}"
        elif k.startswith("backbone.model.norm."):
            k = "res_finetune.norm." + k[len("backbone.model.norm."):]
        out[k] = v
    return out


def load_model_state(model: torch.nn.Module, model_state) -> None:
    """Load a reference-layout state dict strictly. One with no
    `classifier.*` key keeps the model's classifier: the reference always
    saves that head, the JAX package creates it only for the classification
    algorithm (its importer's optional root), and SCL never runs it. Into a
    partially frozen ViT, a dict with no `res_finetune.*` key goes through
    `split_vit_state` first."""
    sd = dict(model_state)
    spec = getattr(model, "spec", None)
    vit = getattr(spec, "vit_spec", None)
    if (vit is not None and spec.vit_front_blocks < vit.depth
            and not any(k.startswith("res_finetune.") for k in sd)):
        sd = split_vit_state(sd, spec.vit_front_blocks)
    if not any(k.startswith("classifier.") for k in sd):
        sd.update((k, v) for k, v in model.state_dict().items()
                  if k.startswith("classifier."))
    model.load_state_dict(sd, strict=True)


def save_checkpoint(model: torch.nn.Module, logdir: str, epoch: int = 0) -> str:
    """Write `model`'s weights as `LOGDIR/checkpoints/checkpoint_epoch_%05d.pth`
    ({"epoch", "model_state"}, reference layout) and return the path."""
    path = os.path.join(logdir, "checkpoints", f"checkpoint_epoch_{epoch:05d}.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": int(epoch), "model_state": state}, path)
    return path
