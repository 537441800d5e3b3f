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
The JAX package's fused SCL kernel (`ops/scl_pallas.py`) takes over only at
N >= 8192 frames; the shipped configs stay far below, so the port has no
counterpart yet.
"""

from __future__ import annotations

import torch


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


class SCL:
    """Algo driver (`algos/scl.py:18-50`): flattens the two-view batch, runs
    the model with the projection head and applies the sequence loss."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.temperature = cfg.SCL.SOFTMAX_TEMPERATURE
        self.label_varience = cfg.SCL.LABEL_VARIENCE
        self.positive_type = cfg.SCL.POSITIVE_TYPE
        self.negative_type = cfg.SCL.NEGATIVE_TYPE

    def compute_loss(self, model, batch):
        """batch: videos (B, V, T, S, S, 3) or (B, V, T, 3, S, S) augmented
        frames, video_masks (B, V, T), seq_lens (B, V), chosen_steps
        (B, V, T), all on the model's device. The model's train/eval mode
        decides BN and dropout, as `train=` does in the JAX package."""
        videos = batch["videos"]
        num_frames = self.cfg.TRAIN.NUM_FRAMES
        B, V, T = videos.shape[:3]
        flat = videos.reshape((B * V,) + videos.shape[2:])
        embs = model(flat, num_frames,
                     video_masks=batch["video_masks"].reshape(B * V, 1, T),
                     project=self.cfg.MODEL.PROJECTION)
        embs = embs.reshape(B, V, num_frames, embs.shape[-1])
        return scl_sequence_loss(
            embs, batch["seq_lens"].reshape(B, V),
            batch["chosen_steps"].reshape(B, V, num_frames),
            batch["video_masks"].reshape(B, V, num_frames),
            temperature=self.temperature, label_varience=self.label_varience,
            positive_type=self.positive_type, negative_type=self.negative_type)
