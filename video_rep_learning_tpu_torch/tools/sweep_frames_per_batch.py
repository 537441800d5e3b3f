"""Sweep MODEL.BASE_MODEL.FRAMES_PER_BATCH of a bench workload on one card,
the counterpart of `tools/sweep_frames_per_batch.py` (and of
`tools/bench_fpb_sweep.py`, which measures the same knob):

    python -m video_rep_learning_tpu_torch.tools.sweep_frames_per_batch \\
        40 80 120 240 [--workload carl|mvf] [--steps 16] [--reps 3] [--device cuda|cpu]

FRAMES_PER_BATCH is the frozen trunk's chunk, a memory knob (the
reference's 40 is a GPU-memory choice): bigger chunks mean fewer, larger
convolution or ViT calls. Each value is measured by `bench._measure` (a
fresh trainer, 2 untimed steps, `--steps` timed ones, clips/s), the values
alternated rep by rep in one process after one untimed warm-up
measurement, so that drift over the run spreads across all of them. Prints
each rep, then a value's mean, population sd and reps.
"""

from __future__ import annotations

import argparse
import statistics

from .common import card, resolve_device


def main(argv=None):
    from .. import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("values", nargs="+", type=int)
    ap.add_argument("--workload", choices=["carl", "mvf"], default="carl")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card(), flush=True)
    raw = bench.raw_size(dev)

    def cfg_for(fpb):
        cfg = bench.WORKLOADS[args.workload](dev)
        cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = fpb
        return cfg

    bench._measure(cfg_for(args.values[0]), 2, raw, dev)  # warm-up, untimed
    results = {v: [] for v in args.values}
    for rep in range(args.reps):
        for v in args.values:
            rate = bench._measure(cfg_for(v), args.steps, raw, dev)
            results[v].append(rate)
            print(f"rep {rep} FPB={v}: {rate:.4f} clips/s", flush=True)
    for v in args.values:
        r = results[v]
        print(f"FPB={v}: mean {statistics.mean(r):.4f} clips/s  "
              f"sd {statistics.pstdev(r):.4f}  {r}", flush=True)
    return results


if __name__ == "__main__":
    main()
