"""Sequence Contrastive Loss (SCL), the CARL training objective, in plain
torch.

Counterpart of `video_rep_learning_tpu/algos/scl.py` (`scl_sequence_loss`,
`SCL.compute_loss`), the same vectorised math over the (N, N) similarity of
the N = B*V*T frame embeddings (reference `algos/scl.py:18-105`):
  logits[i,j] = <e_i, e_j> / tau
  dist[i,j]   = |steps_i / len_i * len_j - steps_j|, 1e6 where either frame
                is padding
  weight[i,j] = negatives: 'single' keeps same-sample pairs, 'noself' drops
                same-view blocks; 1e-6 on padded pairs
  label[i,j]  = row-normalised gaussian exp(-dist^2 / (2 sigma^2)) on the
                cross-view block of the same sample
  loss        = sum(KL(label || exp_logits / sum_j weight exp_logits) * mask)
                / sum(masks)
`scl_loss_dispatch` is the JAX package's gate (`algos/scl.py:92-143`):
the fused loss (`ops/scl.py`, the CUDA kernels of `csrc/scl.cu`) with gauss
positives on a CUDA tensor when VRL_FUSED_SCL is 1, or auto (the default)
with N >= 8192 frames; else this plain composition. Across processes the
loss is each rank's over its local batch, as the reference's DDP and the
JAX package's per-shard branch compute it (negatives never cross ranks),
and DDP's gradient average is the `pmean`; the gate reads the local N.
VRL_GLOBAL_SCL=1 takes global negatives instead (JAX `:133-143`): every
rank computes the loss over the gathered embeddings of the global batch.
"""

from __future__ import annotations

import os

import torch

from ..ops.scl import scl_loss_fused
from ..parallel import all_gather_with_grad, world

FUSED_MIN_FRAMES = 8192


def safe_div(a, b):
    """a / b with NaN results zeroed (`algos/scl.py:13-16`)."""
    out = a / b
    return torch.where(torch.isnan(out), 0.0, out)


def scl_sequence_loss(embs, seq_lens, steps, masks, *, temperature: float,
                      label_varience: float, positive_type: str = "gauss",
                      negative_type: str = "single_noself"):
    """embs (B, V, T, C) projected, L2-normalised frame embeddings; seq_lens
    (B, V) video lengths; steps (B, V, T) chosen frame indices; masks
    (B, V, T) 1 for valid frames. Returns {"loss": 0-d fp32}."""
    B, V, T, C = embs.shape
    N = B * V * T
    dev = embs.device
    e = embs.reshape(N, C).float()
    stp = steps.reshape(N).float()
    lens = seq_lens.reshape(B, V, 1).expand(B, V, T).reshape(N).float()
    m = masks.reshape(N).float()
    input_masks = m[:, None] * m[None, :]

    logits = (e @ e.t()) / temperature
    dist = (stp[:, None] / lens[:, None] * lens[None, :] - stp[None, :]).abs()
    dist = torch.where(input_masks == 0, 1e6, dist)

    idx = torch.arange(N, device=dev)
    sample_id = idx // (V * T)
    view_id = (idx // T) % V
    same_sample = sample_id[:, None] == sample_id[None, :]
    same_view = same_sample & (view_id[:, None] == view_id[None, :])
    cross_view = same_sample & ~same_view

    weight = torch.ones((N, N), dtype=torch.float32, device=dev)
    if "single" in negative_type:
        weight = torch.where(same_sample, weight, 0.0)
    if "noself" in negative_type:
        weight = torch.where(same_view, 0.0, weight)
    weight = torch.where(input_masks == 0, 1e-6, weight)

    if positive_type == "gauss":
        pos_weight = torch.exp(-torch.square(dist) / (2.0 * label_varience))
        pos_in_block = torch.where(cross_view, pos_weight, 0.0)
        row_sum = pos_in_block.sum(dim=1, keepdim=True)
        label = torch.where(cross_view, safe_div(pos_in_block, row_sum), 0.0)
    else:
        label = torch.zeros((N, N), dtype=torch.float32, device=dev)

    exp_logits = torch.exp(logits)
    sum_negative = (weight * exp_logits).sum(dim=1, keepdim=True)
    log_input = torch.log(safe_div(exp_logits, sum_negative) + 1e-6)
    # torch F.kl_div(input_log, target, 'none') == xlogy(t, t) - t*input_log
    kl = torch.special.xlogy(label, label) - label * log_input
    return {"loss": (kl * input_masks).sum() / m.sum()}


def use_fused_scl(positive_type: str, device_type: str, n: int, flag: str) -> bool:
    """The JAX package's rule (`algos/scl.py:116-122`): gauss positives, the
    accelerator, and VRL_FUSED_SCL 1, or anything but 0 with N >= 8192."""
    return (positive_type == "gauss" and device_type == "cuda" and flag != "0"
            and (flag == "1" or n >= FUSED_MIN_FRAMES))


def scl_loss_dispatch(embs, seq_lens, steps, masks, *, temperature,
                      label_varience, positive_type, negative_type):
    """The SCL loss (0-d) through the fused kernels or the plain composition,
    by `use_fused_scl` with VRL_FUSED_SCL read from the environment (0 | 1 |
    auto, default auto). Under VRL_GLOBAL_SCL=1 across processes, over the
    ranks' batches gathered in rank order: the gather's backward sums each
    rank's rows over the ranks, and DDP's average then leaves every
    parameter the gradient of the global loss."""
    if os.environ.get("VRL_GLOBAL_SCL", "0") == "1" and world()[0] > 1:
        embs, seq_lens, steps, masks = (all_gather_with_grad(t) for t in
                                        (embs, seq_lens, steps, masks))
    n = embs.shape[0] * embs.shape[1] * embs.shape[2]
    flag = os.environ.get("VRL_FUSED_SCL", "auto")  # 0 | 1 | auto
    if use_fused_scl(positive_type, embs.device.type, n, flag):
        return scl_loss_fused(embs, seq_lens, steps, masks, temperature,
                              label_varience, negative_type)
    return scl_sequence_loss(
        embs, seq_lens, steps, masks, temperature=temperature,
        label_varience=label_varience, positive_type=positive_type,
        negative_type=negative_type)["loss"]


class SCL:
    """Algo driver (`algos/scl.py:18-50`): flattens the two-view batch, runs
    the model with the projection head and applies the sequence loss."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.temperature = cfg.SCL.SOFTMAX_TEMPERATURE
        self.label_varience = cfg.SCL.LABEL_VARIENCE
        self.positive_type = cfg.SCL.POSITIVE_TYPE
        self.negative_type = cfg.SCL.NEGATIVE_TYPE

    def compute_loss(self, model, batch, backbone_warmup_active=False):
        """batch: videos (B, V, T, S, S, 3) or (B, V, T, 3, S, S) augmented
        frames, video_masks (B, V, T), seq_lens (B, V), chosen_steps
        (B, V, T), all on the model's device. The model's train/eval mode
        decides BN and dropout, as `train=` does in the JAX package;
        `backbone_warmup_active` stops the gradient at the backbone's
        features (TRAIN.BACKBONE_WARMUP)."""
        videos = batch["videos"]
        num_frames = self.cfg.TRAIN.NUM_FRAMES
        B, V = videos.shape[:2]
        flat = videos.reshape((B * V,) + videos.shape[2:])
        # the masks have a value a step: with DATA.NUM_CONTEXTS > 1 a view
        # has more frames than steps (the JAX package's reshape to the
        # frames' count raises there; the conv embedder reads no mask)
        embs = model(flat, num_frames,
                     video_masks=batch["video_masks"].reshape(B * V, 1, -1),
                     project=self.cfg.MODEL.PROJECTION,
                     backbone_warmup_active=backbone_warmup_active)
        embs = embs.reshape(B, V, num_frames, embs.shape[-1])
        return {"loss": scl_loss_dispatch(
            embs, batch["seq_lens"].reshape(B, V),
            batch["chosen_steps"].reshape(B, V, num_frames),
            batch["video_masks"].reshape(B, V, num_frames),
            temperature=self.temperature, label_varience=self.label_varience,
            positive_type=self.positive_type, negative_type=self.negative_type)}
