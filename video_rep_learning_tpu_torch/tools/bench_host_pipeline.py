"""Host-only input pipeline: `TrainLoader` clips/s with no device in the
loop, the counterpart of `tools/bench_host_pipeline.py`.

    python -m video_rep_learning_tpu_torch.tools.bench_host_pipeline \\
        [--data DIR] [--epochs 3] [--frames 240] [--workers 0 16]

It iterates the train loader the trainer consumes (`Dataset.get_ssl_item`
-> collate, two views of `--frames` frames a clip, batch 1: the CARL
shape) over the port's synthetic Pouring set (8 train videos of 260-330
frames at 256 x 256, `.npy`; made under DIR when it has none, by default
`build/bench_host_pipeline/` in the checkout), for each DATA.NUM_WORKERS
given, and prints clips/s and frames/s an epoch, then one JSON line. The
JAX tool's decode-cache A/B has no counterpart: the cache serves encoded
videos, and the port's synthetic set is memory-mapped `.npy`, which the
cache passes by. Nothing here imports JAX or touches a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DATA = os.path.join(REPO, "build", "bench_host_pipeline")


def build_cfg(data_dir: str, num_frames: int, workers: int):
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.DATASETS = ["pouring"]
    cfg.TRAINING_ALGO = "scl"
    cfg.PATH_TO_DATASET = data_dir
    cfg.TRAIN.BATCH_SIZE = 1
    cfg.TRAIN.NUM_FRAMES = num_frames
    cfg.DATA.NUM_WORKERS = workers
    return cfg


def run_epochs(cfg, n_epochs: int):
    """(clips/s, frames/s) of each epoch over the real `TrainLoader`."""
    from ..data import construct_dataloader

    loader, _ = construct_dataloader(cfg, "train", no_eval=True)
    out = []
    for epoch in range(n_epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        clips = 0
        for batch in loader:
            clips += batch["videos"].shape[0]
        dt = time.perf_counter() - t0
        out.append((clips / dt, clips * 2 * cfg.TRAIN.NUM_FRAMES / dt))
    return out


def ensure_data(data_dir: str, num_train=8, min_len=260, max_len=330, size=256):
    """The synthetic set under `data_dir` (the pouring split layout), made
    if it has no train index."""
    if not os.path.isfile(os.path.join(data_dir, "train.pkl")):
        from ..data.synthetic import make_pouring

        make_pouring(data_dir, num_train=num_train, num_val=2, min_len=min_len,
                     max_len=max_len, size=size, seed=0)
    return data_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", default=DEFAULT_DATA)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--frames", type=int, default=240,
                   help="TRAIN.NUM_FRAMES (240 = the CARL shape)")
    p.add_argument("--workers", type=int, nargs="+", default=[0, 16],
                   help="DATA.NUM_WORKERS values, one run each (16: the configs')")
    p.add_argument("--size", type=int, default=256, help="frame side of a new set")
    args = p.parse_args(argv)
    ensure_data(args.data, size=args.size)
    rows = []
    for workers in args.workers:
        rates = run_epochs(build_cfg(args.data, args.frames, workers), args.epochs)
        for i, (cps, fps) in enumerate(rates):
            print(f"workers={workers} epoch {i}: {cps:7.2f} clips/s {fps:8.0f} frames/s",
                  flush=True)
            rows.append({"workers": workers, "epoch": i, "clips_per_s": cps,
                         "frames_per_s": fps})
    print(json.dumps({"rows": rows, "frames": args.frames, "data": args.data}), flush=True)
    return rows


if __name__ == "__main__":
    main()
