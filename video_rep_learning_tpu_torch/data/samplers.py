"""Host-side frame samplers (numpy); the port's own copy of
`video_rep_learning_tpu/data/samplers.py`.

One parametrized implementation of the reference's per-dataset
`sample_frames` variants, which differ ONLY in the time_augment block-size
base (SURVEY.md §2.4):
  - 'seq_len':    block = ceil(ratio * seq_len)   — PennAction
                  (`penn_action.py:170-172`), K400 (`kinetics400.py:153-155`),
                  Pouring default (`pouring.py:153-154`)
  - 'num_frames': block = ceil(ratio * num_frames) — Pouring with
                  DATA.SAMPLE_FIX (`pouring.py:150-152`,
                  github.com/minghchen/CARL_code/issues/3)
  - 'num_valid':  block = ceil(ratio * min(seq_len, num_frames)) — FineGym
                  (`finegym.py:186-187`)

Returns (steps, chosen_steps, video_mask) with the reference's exact
semantics: sorted sample-without-replacement inside the block, pad value
seq_len -> mask 0, clamp for chosen_steps, optional TCN anchor/positive
interleaving and multi-context expansion.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def sample_frames(
    rng: np.random.RandomState,
    seq_len: int,
    num_frames: int,
    *,
    strategy: str = "time_augment",
    sampling_region: float = 1.5,
    consistent_offset: float = 0.2,
    block_size_mode: str = "seq_len",
    pre_steps: Optional[np.ndarray] = None,
    tcn: bool = False,
    tcn_positive_window: int = 5,
    num_contexts: int = 1,
    context_stride: int = 1,
):
    """Sample frame indices for one view (`pouring.py:130-189` and clones)."""
    pre_offset = int(pre_steps.min()) if pre_steps is not None else None

    if strategy == "offset_uniform":
        if seq_len >= num_frames:
            steps = np.sort(rng.permutation(seq_len)[:num_frames])
        else:
            steps = np.arange(num_frames)
    elif strategy == "time_augment":
        num_valid = min(seq_len, num_frames)
        expand_ratio = rng.uniform(1.0, sampling_region) if sampling_region > 1 else 1.0
        if block_size_mode == "seq_len":
            block_size = math.ceil(expand_ratio * seq_len)
        elif block_size_mode == "num_frames":
            block_size = math.ceil(expand_ratio * num_frames)
        elif block_size_mode == "num_valid":
            block_size = math.ceil(expand_ratio * num_valid)
        else:
            raise ValueError(block_size_mode)

        if pre_steps is not None and consistent_offset != 0:
            shift = int((1 - consistent_offset) * num_valid)
            low = max(0, min(seq_len - block_size, pre_offset - shift))
            high = max(1, min(seq_len - block_size + 1, pre_offset + shift + 1))
            offset = rng.randint(low, high)
        else:
            offset = rng.randint(0, max(seq_len - block_size, 1))
        steps = offset + np.sort(rng.permutation(block_size)[:num_valid])
        if num_valid < num_frames:
            steps = np.concatenate(
                [steps, np.full(num_frames - num_valid, seq_len, steps.dtype)])
    else:
        raise ValueError(f"Sampling strategy {strategy} is unknown.")

    steps = steps.astype(np.int64)
    if tcn:
        pos_steps = steps + rng.randint(-tcn_positive_window, 0, size=steps.shape)
        steps = np.stack([steps, pos_steps], axis=0).T.reshape(-1)
        num_frames = num_frames * 2

    video_mask = np.ones(num_frames, np.float32)
    video_mask[steps < 0] = 0
    video_mask[steps >= seq_len] = 0
    chosen_steps = np.clip(steps, 0, seq_len - 1)
    if num_contexts == 1:
        steps = chosen_steps
    else:
        ctx = context_stride * np.arange(-(num_contexts - 1), 1)
        steps = np.clip((steps[:, None] + ctx[None, :]).reshape(-1), 0, seq_len - 1)
    return steps, chosen_steps, video_mask


def sample_all_frames(seq_len: int, stride: int = 1):
    """Eval full-video sweep (`pouring.py:113-116`)."""
    steps = np.arange(0, seq_len, stride, dtype=np.int64)
    return steps, steps.copy(), np.ones(len(steps), np.float32)


def sample_two_views(rng, seq_len, num_frames, **kw):
    """The SSL two-view draw: view 1 is constrained near view 0 via the
    consistent-offset window (`pouring.py:79-80`)."""
    s0, c0, m0 = sample_frames(rng, seq_len, num_frames, **kw)
    s1, c1, m1 = sample_frames(rng, seq_len, num_frames, pre_steps=s0, **kw)
    return (s0, c0, m0), (s1, c1, m1)
