"""Synthetic datasets for smoke runs, benchmarks and tests: the port's copy
of `tools/make_synthetic_data.py` (the same files, index and frames for the
same arguments and seed), kept in the port so that nothing here needs the
JAX package.

Three layouts:
- pouring: `videos/{split}_{split}_{i}.{fmt}` and a `{split}.pkl` index;
- penn_action: `videos/{split}_{i:04d}_{action}.{fmt}` and the
  `(entries, action_to_indices)` pickle, the actions cycling through the
  first `num_actions` of PENN_ACTION_LIST;
- kinetics400: `train/{youtube_id}_000000_000010.{fmt}` and `train.csv`
  (label,youtube_id,time_start,time_end,split), train only.

`fmt` is npy ((T, H, W, 3) uint8 stores, no codec needed) or mp4 (H.264
through the native encoder, `data/decode.py::encode_video`). The command
line defaults to npy, where the JAX tool defaults to mp4, and honours
`--format` for every layout, where the JAX tool writes K400 as mp4 always
(the port's K400 loader reads a `.npy` store in place of a missing mp4);
with `--format mp4` both write the same files.

Videos are procedural: a moving bright square whose vertical position encodes
progress, with `num_phases` contiguous phase segments as frame labels, so the
downstream tasks (tau, retrieval, probe, progression) have real structure.

    python -m video_rep_learning_tpu_torch.data.synthetic --out DATA/pouring \\
        --num_train 6 --num_val 6 --min_len 150 --max_len 600 --size 256 \\
        [--format npy|mp4] [--dataset pouring|penn_action|kinetics400]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from .decode import encode_video
from .splits import PENN_ACTION_LIST

DATASETS = ("pouring", "penn_action", "kinetics400")
FORMATS = ("npy", "mp4")


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


def make_k400_split(out_dir, n, rng, min_len, max_len, size, fmt="mp4"):
    """The Kinetics-400 layout: `train/*.{fmt}` named
    `{youtube_id}_{start:06d}_{end:06d}.{fmt}` and `train.csv`, the
    reference's format (`kinetics400.py:34,86`)."""
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    rows = ["label,youtube_id,time_start,time_end,split"]
    for i in range(n):
        seq_len = rng.randint(min_len, max_len + 1)
        frames = make_video(rng, seq_len, size, size)
        ytid = f"synth{i:05d}"
        fname = f"{ytid}_{0:06d}_{10:06d}.{fmt}"
        encode_video(os.path.join(out_dir, "train", fname), frames, fps=25.0)
        rows.append(f"x,{ytid},0,10,train")
    with open(os.path.join(out_dir, "train.csv"), "w") as f:
        f.write("\n".join(rows))


def make_split(out_dir, split, n, rng, min_len, max_len, size, num_phases=4,
               fmt="npy", dataset="pouring", num_actions=2):
    """Write `n` videos of a pouring or penn_action split under
    `out_dir/videos` and its index `{split}.pkl`; return the entries."""
    penn = dataset == "penn_action"
    actions = PENN_ACTION_LIST[:num_actions] if penn else [None]
    entries = []
    action_to_indices = [[] for _ in PENN_ACTION_LIST]
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    for i in range(n):
        seq_len = rng.randint(min_len, max_len + 1)
        frames = make_video(rng, seq_len, size, size)
        action = actions[i % len(actions)]
        name = f"{i:04d}_{action}" if penn else f"{split}_{i}"
        rel = os.path.join("videos", f"{split}_{name}.{fmt}")
        encode_video(os.path.join(out_dir, rel), frames, fps=25.0)
        bounds = np.sort(rng.choice(
            np.arange(1, seq_len), size=num_phases - 1, replace=False))
        labels = np.zeros(seq_len, np.int64)
        for k, b in enumerate(bounds):
            labels[b:] = k + 1
        entry = {"id": i, "name": name, "video_file": rel,
                 "frame_label": labels, "seq_len": seq_len,
                 "height": size, "width": size}
        if penn:
            a_idx = PENN_ACTION_LIST.index(action)
            entry["action_label"] = a_idx
            action_to_indices[a_idx].append(i)
        entries.append(entry)
    with open(os.path.join(out_dir, f"{split}.pkl"), "wb") as f:
        pickle.dump((entries, action_to_indices) if penn else entries, f)
    return entries


def make_dataset(out_dir, dataset="pouring", fmt="npy", num_train=8, num_val=4,
                 min_len=40, max_len=80, size=64, num_phases=4, seed=0,
                 num_actions=2):
    """One synthetic set under `out_dir`: a train and a val split (K400:
    train only); returns the splits' index entries (K400: none)."""
    if dataset not in DATASETS or fmt not in FORMATS:
        raise ValueError(f"dataset {dataset} / format {fmt}")
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    if dataset == "kinetics400":
        make_k400_split(out_dir, num_train, rng, min_len, max_len, size, fmt)
        return ()
    return tuple(make_split(out_dir, split, n, rng, min_len, max_len, size,
                            num_phases, fmt, dataset, num_actions)
                 for split, n in (("train", num_train), ("val", num_val)))


def make_pouring(out_dir, num_train=8, num_val=4, min_len=40, max_len=80,
                 size=64, num_phases=4, seed=0, fmt="npy"):
    """A pouring train and val split under `out_dir`; returns both index
    lists."""
    return make_dataset(out_dir, "pouring", fmt, num_train, num_val, min_len,
                        max_len, size, num_phases, seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num_train", type=int, default=8)
    p.add_argument("--num_val", type=int, default=4)
    p.add_argument("--min_len", type=int, default=40)
    p.add_argument("--max_len", type=int, default=80)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--num_phases", type=int, default=4)
    p.add_argument("--format", choices=FORMATS, default="npy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", choices=DATASETS, default="pouring",
                   help="penn_action writes the (entries, action_to_indices) "
                        "pickle with per-action names; kinetics400 writes "
                        "train/*.<format> + train.csv")
    p.add_argument("--num_actions", type=int, default=2,
                   help="number of PennAction actions to synthesize")
    a = p.parse_args(argv)
    make_dataset(a.out, a.dataset, a.format, a.num_train, a.num_val, a.min_len,
                 a.max_len, a.size, a.num_phases, a.seed, a.num_actions)
    print(f"synthetic dataset written to {a.out}")


if __name__ == "__main__":
    main()
