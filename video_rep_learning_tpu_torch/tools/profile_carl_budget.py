"""The training step's budget by component, the counterpart of
`tools/profile_carl_budget.py`: a ladder of prefixes of the port's step,
each timed, and the differences between rungs as component costs.

    python -m video_rep_learning_tpu_torch.tools.profile_carl_budget
        [--iters 8] [--workload carl|mvf] [--device cuda|cpu]

The rungs, on the `bench.py` workload (full width on the card) and its
synthetic batch staged on the device once:

    null     a trivial device op (the cost of a call)
    augment  `Trainer.augment`: the two SSL views (the crop + photometric
             kernel under USE_AMP)
    trunk    augment + the frozen trunk (`models/carl.py::_run_frozen`)
    fwd      augment + the whole model forward in train mode (trunk, the
             trainable tail, the head), with autograd recording
    loss     fwd + the SCL loss (`algo.compute_loss`)
    grad     loss + the backward (gradients zeroed first)
    full     `Trainer.train_step`: grad + clip + Adam

Each rung is timed two ways: on a card, the device's time a call with the
calls queued back to back (CUDA events after a sleep kernel that lets the
host run ahead, `tools/common.py::cuda_ms`); and the host clock over the
calls ended by a synchronise, the time a caller waits a call. Where the
host-clock time is above the device time, the device idles for the
difference: the rung is host-bound (or waits on the host inside the
call). Each is the best of 2 rounds of `--iters` calls after a warm-up
call. On the CPU only the host clock exists; the device column reads "not
measured".
"""

from __future__ import annotations

import argparse
import itertools
import time

import torch

from .common import card, cuda_ms, resolve_device

RUNGS = ("null", "augment", "trunk", "fwd", "loss", "grad", "full")
# (component, upper rung, lower rung)
BUDGET = (("augment (crop + photometric)", "augment", "null"),
          ("frozen trunk forward", "trunk", "augment"),
          ("trainable tail + head forward", "fwd", "trunk"),
          ("SCL loss", "loss", "fwd"),
          ("backward (tail, head, SCL)", "grad", "loss"),
          ("clip + Adam", "full", "grad"),
          ("TOTAL (full step)", "full", "null"))


def ladder(trainer, batch, dev_batch):
    """{rung: fn(it)}: each a prefix of `trainer.train_step` on the batch."""
    model, cfg = trainer.model, trainer.cfg

    def views(it):
        return trainer.augment(batch, dev_batch, 0, 0, it)

    def f_null(it):
        return dev_batch["video_masks"].sum()

    def f_trunk(it):
        v = views(it)
        return model._run_frozen(model._nchw(v.flatten(0, 2)))

    def f_fwd(it):
        v = views(it)
        B, V, T = v.shape[:3]
        return trainer.net(v.flatten(0, 1), cfg.TRAIN.NUM_FRAMES,
                           video_masks=dev_batch["video_masks"].reshape(B * V, 1, T),
                           project=cfg.MODEL.PROJECTION)

    def f_loss(it):
        return trainer.algo.compute_loss(trainer.net, dict(dev_batch, videos=views(it)))[
            "loss"]

    def f_grad(it):
        loss = f_loss(it)
        trainer.optimizer.zero_grad()
        loss.backward()
        return loss

    def f_full(it):
        return trainer.train_step(batch, dev_batch, 0, it, 1e-4)

    return {"null": f_null, "augment": views, "trunk": f_trunk, "fwd": f_fwd,
            "loss": f_loss, "grad": f_grad, "full": f_full}


def time_rung(fn, iters, device, rounds=2):
    """(device ms, host-clock ms) a call, each the best of `rounds` rounds
    of `iters` calls after one warm-up call; the device time None on the
    CPU."""
    count = itertools.count(100)
    call = lambda: fn(next(count))  # noqa: E731
    on_card = device.type == "cuda"
    call()
    dev_ms, host_ms = [], []
    for _ in range(rounds):
        if on_card:
            dev_ms.append(cuda_ms(call, reps=iters, warmup=0)[0])
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        if on_card:
            torch.cuda.synchronize(device)
        host_ms.append((time.perf_counter() - t0) * 1e3 / iters)
    return (min(dev_ms) if on_card else None), min(host_ms)


def run(trainer, batch, dev_batch, iters, device):
    """{rung: (device ms, host ms)}, the rungs in order, `full` last (it
    moves the weights)."""
    trainer.model.train()
    fns = ladder(trainer, batch, dev_batch)
    return {name: time_rung(fns[name], iters, device) for name in RUNGS}


def _ms(v):
    return "not measured" if v is None else f"{v:8.2f}"


def report(times):
    """The rung lines, then the budget: each component's device and host
    cost (differences between rungs)."""
    lines = [f"{'rung':8s} {'device ms':>12s} {'host clock ms':>14s}"]
    for name in RUNGS:
        d, h = times[name]
        lines.append(f"{name:8s} {_ms(d):>12s} {_ms(h):>14s}")
    lines.append("--- budget (differences between rungs) ---")
    for label, hi, lo in BUDGET:
        d = (None if times[hi][0] is None else times[hi][0] - times[lo][0])
        h = times[hi][1] - times[lo][1]
        lines.append(f"{label:32s} device {_ms(d):>12s} ms  host {_ms(h):>12s} ms")
    return lines


def main(argv=None):
    from .. import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--workload", choices=["carl", "mvf"], default="carl")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card(), flush=True)
    cfg = bench.WORKLOADS[args.workload](dev)
    trainer, batch, dev_batch = bench.step_setup(cfg, bench.raw_size(dev), dev)
    times = run(trainer, batch, dev_batch, args.iters, dev)
    print(f"{args.workload} on {dev}, {args.iters} calls a round", flush=True)
    for line in report(times):
        print(line, flush=True)
    return times


if __name__ == "__main__":
    main()
