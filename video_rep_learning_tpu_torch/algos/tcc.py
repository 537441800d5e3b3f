"""Temporal Cycle-Consistency (TCC) loss, in plain torch.

Counterpart of `video_rep_learning_tpu/algos/tcc.py` (`tcc_loss`, `TCC`):
every ordered pair (i, j), i != j, of the B sequences is evaluated in one
batched computation, as the JAX package's vmap does:
  sim_12   = similarity(e_i, e_j) / C / tau        (T, T)
  nn       = softmax(sim_12) @ e_j                 soft nearest neighbours
  logits   = similarity(nn, e_i) / C / tau         cycle back to e_i
  labels   = eye(T), optionally label-smoothed
similarity is -(|a|^2 + |b|^2 - 2 a.b) (l2) or a.b (cosine). The loss is
then, over the B(B-1)T rows:
- classification: mean(xlogy(labels, labels) - labels * logits), the raw
  logits taken as the "log input" (the reference's quirk);
- regression_mse / _var / _huber on the predicted time sum(steps * beta)
  against the true time sum(steps * labels), beta = softmax(logits), steps
  divided by the sequence length under NORMALIZE_INDICES; _var adds the
  predicted variance, log(var) unclamped, as the JAX package.
All of it in fp32 (the JAX package's products run at Precision.HIGHEST; the
port leaves TF32 off, PyTorch's default for matmuls). The per-rank pair
list of the JAX data-parallel branch comes with DDP.
"""

from __future__ import annotations

import torch


def _scaled_similarity(e1, e2, similarity_type: str, temperature: float):
    """(P, T, C) x (P, T, C) -> (P, T, T) similarities / C / tau."""
    channels = e1.shape[-1]
    if similarity_type == "cosine":
        sim = torch.matmul(e1, e2.transpose(1, 2))
    elif similarity_type == "l2":
        n1 = torch.square(e1).sum(dim=2)[:, :, None]
        n2 = torch.square(e2).sum(dim=2)[:, None, :]
        sim = -(n1 + n2 - 2.0 * torch.matmul(e1, e2.transpose(1, 2)))
    else:
        raise ValueError(similarity_type)
    return sim / channels / temperature


def tcc_loss(embs, seq_lens, steps, *, loss_type: str, similarity_type: str,
             temperature: float, label_smoothing: float,
             variance_lambda: float, huber_delta: float,
             normalize_indices: bool):
    """embs (B, T, C), seq_lens (B,), steps (B, T) -> the loss dict (0-d
    fp32 "loss"; regression_mse_var adds "squared_error" and
    "pred_time_log_var"). `huber_delta` is read by neither package: the
    Huber loss has delta 1 (torch SmoothL1Loss), as in the reference."""
    B, T, _ = embs.shape
    if B < 2:
        raise ValueError("TCC needs a batch of at least 2 sequences")
    dev = embs.device
    embs = embs.float()
    # the pairs on the host (no device sync), row-major as jnp.nonzero
    ii, jj = (~torch.eye(B, dtype=torch.bool)).nonzero(as_tuple=True)
    ii, jj = ii.to(dev), jj.to(dev)
    P = ii.shape[0]
    e1, e2 = embs[ii], embs[jj]
    sim_12 = _scaled_similarity(e1, e2, similarity_type, temperature)
    nn_embs = torch.matmul(torch.softmax(sim_12, dim=-1), e2)
    logits = _scaled_similarity(nn_embs, e1, similarity_type,
                                temperature).reshape(P * T, T)
    eye = torch.eye(T, dtype=torch.float32, device=dev)
    if label_smoothing:
        eye = ((1.0 - T * label_smoothing / (T - 1)) * eye
               + label_smoothing / (T - 1) * torch.ones_like(eye))
    labels = eye.expand(P, T, T).reshape(P * T, T)

    if loss_type == "classification":
        kl = torch.special.xlogy(labels, labels) - labels * logits
        return {"loss": kl.mean()}

    stepsf = steps[ii].float()[:, None, :].expand(P, T, T).reshape(P * T, T)
    if normalize_indices:
        lensf = seq_lens[ii].float()[:, None].expand(P, T).reshape(P * T)
        stepsf = stepsf / lensf[:, None]
    beta = torch.softmax(logits, dim=-1)
    true_time = (stepsf * labels).sum(dim=-1)
    pred_time = (stepsf * beta).sum(dim=-1)

    if loss_type in ("regression_mse", "regression_mse_var"):
        if "var" in loss_type:
            var = (torch.square(stepsf - pred_time[:, None]) * beta).sum(dim=-1)
            log_var = torch.log(var)
            sq_err = torch.square(true_time - pred_time)
            loss = (torch.exp(-log_var) * sq_err + variance_lambda * log_var).mean()
            return {"loss": loss, "squared_error": sq_err.mean(),
                    "pred_time_log_var": log_var.mean()}
        return {"loss": torch.square(pred_time - true_time).mean()}
    if loss_type == "regression_huber":
        diff = (pred_time - true_time).abs()
        return {"loss": torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).mean()}
    raise ValueError(loss_type)


class TCC:
    """Algo driver (`algos/tcc.py:98-157` of the JAX package): under SSL the
    two views of each clip are flattened into 2B sequences."""

    def __init__(self, cfg):
        self.cfg = cfg
        t = cfg.TCC
        self.kw = dict(loss_type=t.LOSS_TYPE, similarity_type=t.SIMILARITY_TYPE,
                       temperature=t.SOFTMAX_TEMPERATURE,
                       label_smoothing=t.LABEL_SMOOTHING,
                       variance_lambda=t.VARIANCE_LAMBDA,
                       huber_delta=t.HUBER_DELTA,
                       normalize_indices=t.NORMALIZE_INDICES)

    def compute_loss(self, model, batch, backbone_warmup_active=False):
        """batch: videos (B, T, S, S, 3), or (B, V, T, ...) under SSL,
        augmented; video_masks, chosen_steps (B[, V], T); seq_lens (B[, V])."""
        num_frames = self.cfg.TRAIN.NUM_FRAMES
        videos = batch["videos"]
        steps, seq_lens = batch["chosen_steps"], batch["seq_lens"]
        if self.cfg.SSL:
            videos = videos.reshape((-1,) + videos.shape[2:])
            steps = steps.reshape(-1, num_frames)
            seq_lens = seq_lens.reshape(-1)
        # (B, T) masks as (B, 1, T) key masks; the conv and vanilla
        # embedders read none
        embs = model(videos, num_frames,
                     video_masks=batch["video_masks"].reshape(videos.shape[0], 1, -1),
                     backbone_warmup_active=backbone_warmup_active)
        return tcc_loss(embs, seq_lens, steps, **self.kw)
