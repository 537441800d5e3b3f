"""Aggregate metrics across multi-trial runs of the port: its own copy of
the root `read_results.py`.

    python -m video_rep_learning_tpu_torch.read_results --logdir RUN \\
        [--finegym] [--plot out.png]

Walks `<base>` and its `<base>-trialNN` run directories, greps the final
`metrics/all_*` lines (or FineGym `classification_<fraction>/val`) out of
each `stdout.log` (the line format of `logging_utils.py`), falls back to
the `scalars.jsonl` files `utils/summary.py` writes where there is no
TensorBoard, and reports mean +/- 2 sigma a metric. `micro` debug runs are
excluded (the reference's results reader, `read_results.py:13-235`).
matplotlib is imported only for `--plot`.
"""

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

METRIC_RE = re.compile(r"metrics/all_(\w+): ([0-9.+-eE]+)")
FG_RE = re.compile(r"classification_([0-9.]+)/val: ([0-9.+-eE]+)")


def parse_stdout_log(path, finegym=False):
    """Last value per metric from one stdout.log."""
    out = {}
    rx = FG_RE if finegym else METRIC_RE
    with open(path) as f:
        for line in f:
            m = rx.search(line)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def parse_jsonl(path, finegym=False):
    out = {}
    prefix = "classification_" if finegym else "metrics/all_"
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            tag = rec.get("tag", "")
            if finegym and tag.startswith(prefix) and tag.endswith("/val"):
                out[tag[len(prefix):-4]] = rec["value"]
            elif not finegym and tag.startswith(prefix):
                out[tag[len(prefix):]] = rec["value"]
    return out


def collect_trials(base, finegym=False):
    """Find <base> and <base>-trialNN dirs; parse each run's metrics."""
    run_dirs = [base] + sorted(glob.glob(base + "-trial*"))
    results = []
    for d in run_dirs:
        if "micro" in os.path.basename(d):
            continue
        metrics = {}
        log = os.path.join(d, "stdout.log")
        if os.path.isfile(log):
            metrics = parse_stdout_log(log, finegym)
        if not metrics:
            for jl in glob.glob(os.path.join(d, "*", "scalars.jsonl")):
                metrics.update(parse_jsonl(jl, finegym))
        if metrics:
            results.append((d, metrics))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--logdir", required=True, help="base run dir (trials at -trialNN)")
    p.add_argument("--finegym", action="store_true")
    p.add_argument("--plot", default=None)
    args = p.parse_args(argv)

    trials = collect_trials(args.logdir.rstrip("/"), args.finegym)
    if not trials:
        print("no results found")
        return 1
    keys = sorted({k for _, m in trials for k in m})
    print(f"{len(trials)} trial(s): " + ", ".join(d for d, _ in trials))
    summary = {}
    for k in keys:
        vals = np.array([m[k] for _, m in trials if k in m])
        summary[k] = (vals.mean(), 2 * vals.std())
        print(f"  {k}: {vals.mean():.4f} +/- {2 * vals.std():.4f}  (n={len(vals)})")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        names = list(summary)
        means = [summary[k][0] for k in names]
        errs = [summary[k][1] for k in names]
        ax.bar(range(len(names)), means, yerr=errs)
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=30, ha="right")
        fig.tight_layout()
        fig.savefig(args.plot)
        print("plot saved to", args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
