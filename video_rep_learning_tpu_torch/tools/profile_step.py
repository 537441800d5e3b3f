"""Profile warm training steps of a bench workload under torch.profiler,
the counterpart of `tools/profile_step.py`:

    python -m video_rep_learning_tpu_torch.tools.profile_step [carl|mvf]
        [--steps 4] [--out build/profile_step] [--device cuda|cpu]

Builds the workload of `bench.py` (`carl_cfg` / `mvf_cfg`: full width on
the card), stages its synthetic batch on the device, runs 2 untimed steps,
then `--steps` steps under the profiler (CPU and, on a card, CUDA
activity). Prints ms a step and clips/s (host clock around the steps and a
synchronise), the device's busy share of that window (the sum of its
kernels' and copies' time over the window), and the top 40 device
operations by time a step with their launches a step; the Chrome trace
goes to `--out/trace.json`. `key_averages()` takes the place of the JAX
tool's reading of the trace file. On the CPU there is no device: the
table lists host operations, and the busy share is "not measured".

`profile`, `busy_line` and `table` are the parts `chip_smoke.py` uses for
its profiled steps, epochs and videos.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .common import card, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(step, n_steps, device, trace=None):
    """`step(i)` for i in range(n_steps) under torch.profiler, after the
    caller's warm-up. Returns {"wall_s", "busy_s", "events"}: the host
    clock over the steps ended by a synchronise; on a card the device's
    busy seconds (the kernels' and copies' self time) and the device
    events, on the CPU None and the host operations. Writes the Chrome
    trace to `trace` when given."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    device = torch.device(device)
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    _sync(device)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        _sync(device)
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    if on_card:
        # kernels and copies on the card (the CPU ops that launched them
        # carry the same time again)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e6
        events.sort(key=lambda e: -e.self_device_time_total)
    else:
        events = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
        busy = None
        events.sort(key=lambda e: -e.self_cpu_time_total)
    return {"wall_s": wall, "busy_s": busy, "events": events}


def busy_line(prof, n_calls):
    """The window's wall ms a call and the device's busy share of it."""
    wall = prof["wall_s"]
    if prof["busy_s"] is None:
        return (f"wall {wall / n_calls * 1e3:.1f} ms a call; device busy: not "
                f"measured (no device)")
    busy = prof["busy_s"]
    return (f"wall {wall / n_calls * 1e3:.1f} ms a call, device busy "
            f"{busy / n_calls * 1e3:.1f} ms = {busy / wall * 100:.1f}% (idle "
            f"{100 - busy / wall * 100:.1f}%)")


def table(prof, n_steps, top=40):
    """Lines of the `top` operations by self time a step: ms a step, calls
    a step, name (device operations on a card, host ones on the CPU)."""
    on_card = prof["busy_s"] is not None
    lines = []
    for e in prof["events"][:top]:
        us = e.self_device_time_total if on_card else e.self_cpu_time_total
        lines.append(f"{us / 1e3 / n_steps:9.3f} ms/step  x{e.count / n_steps:<7g} "
                     f"{e.key[:110]}")
    return lines


def main(argv=None):
    from .. import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default="mvf", choices=["carl", "mvf"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile_step"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card(), flush=True)
    cfg = bench.WORKLOADS[args.workload](dev)
    trainer, batch, dev_batch = bench.step_setup(cfg, bench.raw_size(dev), dev)
    for i in range(2):
        trainer.train_step(batch, dev_batch, 0, i, 1e-4)
    prof = profile(lambda i: trainer.train_step(batch, dev_batch, 0, 100 + i, 1e-4),
                   args.steps, dev, os.path.join(args.out, "trace.json"))
    dt = prof["wall_s"] / args.steps
    B = cfg.TRAIN.BATCH_SIZE
    print(f"{args.workload}: {dt * 1e3:.1f} ms/step ({B / dt:.2f} clips/s) on {dev}",
          flush=True)
    print(busy_line(prof, args.steps), flush=True)
    print(f"--- top {'device' if dev.type == 'cuda' else 'host'} operations a step",
          flush=True)
    for line in table(prof, args.steps):
        print(line, flush=True)
    print(f"trace: {os.path.join(args.out, 'trace.json')}", flush=True)
    return prof


if __name__ == "__main__":
    main()
