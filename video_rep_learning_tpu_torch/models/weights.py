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

The reference layout has no place for the conv and vanilla embedders
(the JAX exporter emits a transformer head whatever the model), so
`context_embed_state_dict` carries their JAX parameters and batch
statistics into the port's `embed.*` names (the JAX module names);
the rest of such a model's dict is the reference layout's.

A partially frozen ViT (LAYER = L below the depth) keeps the front's
`backbone.model.{patch_embed, cls_token, pos_embed, blocks.0..L-1}` and
moves blocks L.. and the final norm into the trainable back end,
`res_finetune.blocks.{i}` (global i, timm names) and `res_finetune.norm`,
so `set_trainable` trains them with no rule of their own. The reference
layout has every block under `backbone.model`: `split_vit_state` maps it
onto the partial model, and `load_model_state` does so for a dict with no
`res_finetune.*` key (a warm start from a fully frozen MV-Former `.pth`).

Late fusion over a ViT with LATE_TYPE cls: the reference assigns the bare
timm model to `backbone`, so its dict holds the ViT under `backbone.*`, not
`backbone.model.*` (the JAX exporter's `wrapped=False`). The port keeps its
module tree and maps the keys: `load_model_state` reads such a dict (and
nothing else) into `backbone.model.*`, and `reference_state` writes it back
under `backbone.*`, which every checkpoint writer of the port uses.
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


def context_embed_state_dict(params, batch_stats) -> Dict[str, np.ndarray]:
    """The JAX `ConvEmbed` / `VanillaEmbed` variables, flat dicts keyed by
    flax path tuples under ("embed", ...), -> the port's `embed.*` state
    dict (numpy): Conv kernels (k, k, k, I, O) -> (O, I, k, k, k), Dense
    kernels transposed, BatchNorm scale / bias / mean / var ->
    weight / bias / running_mean / running_var (and a zero
    num_batches_tracked). Raises on a path it does not know."""
    sd = {}
    for path, v in params.items():
        if path[0] != "embed":
            continue
        name, leaf = path[1], path[-1]
        v = np.asarray(v, np.float32)
        if name.startswith("convbn") and path[2:] in (("BatchNorm_0", "scale"),
                                                      ("BatchNorm_0", "bias")):
            sd[f"embed.{name}.{'weight' if leaf == 'scale' else 'bias'}"] = v
            sd[f"embed.{name}.num_batches_tracked"] = np.asarray(0, np.int64)
        elif name.startswith("conv") and path[2:] in (("kernel",), ("bias",)):
            sd[f"embed.{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                np.transpose(v, (4, 3, 0, 1, 2)) if leaf == "kernel" else v)
        elif ((name.startswith("fc") or name == "embedding_layer")
              and path[2:] in (("Dense_0", "kernel"), ("Dense_0", "bias"))):
            sd[f"embed.{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                v.T if leaf == "kernel" else v)
        else:
            raise KeyError(f"not a conv / vanilla embedder parameter: {path}")
    for path, v in batch_stats.items():
        if path[0] != "embed":
            continue
        if not (path[1].startswith("convbn")
                and path[2:] in (("BatchNorm_0", "mean"), ("BatchNorm_0", "var"))):
            raise KeyError(f"not a conv embedder statistic: {path}")
        which = "running_mean" if path[-1] == "mean" else "running_var"
        sd[f"embed.{path[1]}.{which}"] = np.asarray(v, np.float32)
    return sd


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


_WRAPPED, _BARE = "backbone.model.", "backbone."


def unwrapped_vit(model: torch.nn.Module) -> bool:
    """Whether the reference layout of `model` holds its ViT under
    `backbone.*` (late fusion, LATE_TYPE cls) rather than `backbone.model.*`."""
    spec = getattr(model, "spec", None)
    return (getattr(spec, "vit_spec", None) is not None
            and spec.fusion_type == "late" and spec.late_type == "cls")


def reference_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """`model`'s state dict on the CPU in the reference layout: a late-cls
    ViT's `backbone.model.*` as `backbone.*`, everything else as it is."""
    bare = unwrapped_vit(model)
    return {(_BARE + k[len(_WRAPPED):] if bare and k.startswith(_WRAPPED) else k):
            v.detach().cpu() for k, v in model.state_dict().items()}


def load_model_state(model: torch.nn.Module, model_state) -> None:
    """Load a reference-layout state dict strictly. One with no
    `classifier.*` key keeps the model's classifier: the reference always
    saves that head, the JAX package creates it only for the classification
    algorithm (its importer's optional root), and SCL never runs it. Into a
    late-cls ViT, `backbone.*` keys go to `backbone.model.*` (a dict in the
    wrapped layout then fails the strict load). Into a partially frozen ViT,
    a dict with no `res_finetune.*` key goes through `split_vit_state`
    first."""
    sd = dict(model_state)
    if unwrapped_vit(model):
        sd = {(_WRAPPED + k[len(_BARE):] if k.startswith(_BARE) else k): v
              for k, v in sd.items()}
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
    torch.save({"epoch": int(epoch), "model_state": reference_state(model)}, path)
    return path
