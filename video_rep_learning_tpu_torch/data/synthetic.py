"""A synthetic Pouring-format dataset of `.npy` frame stores plus the pickle
index, for smoke runs and tests: the npy part of `tools/make_synthetic_data.py`
(the same videos and index for the same arguments and seed), kept in the port
so that nothing here needs the JAX package.

Videos are procedural: a moving bright square whose vertical position encodes
progress, with `num_phases` contiguous phase segments as frame labels, so the
downstream tasks (tau, retrieval, probe, progression) have real structure.

    python -m video_rep_learning_tpu_torch.data.synthetic --out DATA/pouring \\
        --num_train 6 --num_val 6 --min_len 150 --max_len 600 --size 256
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def make_video(rng, seq_len, h, w):
    frames = np.zeros((seq_len, h, w, 3), np.uint8)
    bg = rng.randint(0, 60, size=3)
    sq = rng.randint(150, 255, size=3)
    side = max(4, h // 6)
    for t in range(seq_len):
        frames[t] = bg
        prog = t / max(1, seq_len - 1)
        y = int(prog * (h - side))
        x = int((0.3 + 0.4 * np.sin(prog * 3.1)) * (w - side))
        frames[t, y:y + side, x:x + side] = sq
        # time-varying texture so frames are distinguishable
        frames[t, :2, :, :] = (t * 7) % 255
    return frames


def make_split(out_dir, split, n, rng, min_len, max_len, size, num_phases=4):
    """Write `n` videos as `videos/{split}_{split}_{i}.npy` and their index as
    `{split}.pkl`; return the index entries."""
    entries = []
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    for i in range(n):
        seq_len = rng.randint(min_len, max_len + 1)
        frames = make_video(rng, seq_len, size, size)
        name = f"{split}_{i}"
        rel = os.path.join("videos", f"{split}_{name}.npy")
        np.save(os.path.join(out_dir, rel), frames)
        bounds = np.sort(rng.choice(
            np.arange(1, seq_len), size=num_phases - 1, replace=False))
        labels = np.zeros(seq_len, np.int64)
        for k, b in enumerate(bounds):
            labels[b:] = k + 1
        entries.append({"id": i, "name": name, "video_file": rel,
                        "frame_label": labels, "seq_len": seq_len,
                        "height": size, "width": size})
    with open(os.path.join(out_dir, f"{split}.pkl"), "wb") as f:
        pickle.dump(entries, f)
    return entries


def make_pouring(out_dir, num_train=8, num_val=4, min_len=40, max_len=80,
                 size=64, num_phases=4, seed=0):
    """A train and a val split under `out_dir`; returns both index lists."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    return (make_split(out_dir, "train", num_train, rng, min_len, max_len,
                       size, num_phases),
            make_split(out_dir, "val", num_val, rng, min_len, max_len, size,
                       num_phases))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num_train", type=int, default=8)
    p.add_argument("--num_val", type=int, default=4)
    p.add_argument("--min_len", type=int, default=40)
    p.add_argument("--max_len", type=int, default=80)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--num_phases", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    make_pouring(a.out, a.num_train, a.num_val, a.min_len, a.max_len, a.size,
                 a.num_phases, a.seed)
    print(f"synthetic dataset written to {a.out}")


if __name__ == "__main__":
    main()
