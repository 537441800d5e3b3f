"""What the micro-benchmarks share: the device, CUDA-event timing, the
card's name and power limit, the result rows and the command line.

Timing takes the TPU scripts' place for their chained `fori_loop` and its
calibrated overhead, which existed because the TPU's host link returned
before the device finished: CUDA events recorded on the stream around
`reps` launches time the launches themselves, after a warm-up. A short
kernel can take less device time than its wrapper takes on the host, and
the events would then time the host's gaps between launches; so the stream
first runs a sleep kernel long enough for the host to queue all `reps`
calls, and the events time them back to back on the device. The host's
time to issue one call is kept beside it: a caller that launches calls
back to back pays the larger of the two.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..ops import bounds


def resolve_device(device) -> torch.device:
    """torch.device(device); "cuda" without a card raises (a measurement
    never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here; pass --device cpu to run the "
                           "plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"runs on cuda or cpu, not {dev}")
    return dev


SLEEP_CYCLES_PER_S = 2e9  # the sleep kernel counts SM clocks (H100 SXM: 1.98 GHz at most)


def cuda_ms(fn, reps=20, warmup=5):
    """(device ms, host ms) a call of `fn` over `reps` calls queued back to
    back after `warmup` calls: the events' mean, and the host's mean time
    to issue one call (the wrapper's Python and launch cost, which a caller
    pays whenever it exceeds the device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # the host's time to queue one call
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s + 1e-3, 1.0) * SLEEP_CYCLES_PER_S))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def timed(kernel, plain, library=None, reps=20):
    """(kernel, plain, library, kernel host) ms in turns: plain, kernel,
    kernel, plain, then the library call twice; each the mean of its two
    runs (library None without one). The first three are device times, the
    last the host's time to issue one kernel call (`cuda_ms`)."""
    w = min(5, reps)
    (p1, _), (k1, h1), (k2, h2), (p2, _) = (cuda_ms(f, reps, w)
                                            for f in (plain, kernel, kernel, plain))
    lib = None
    if library is not None:
        lib = (cuda_ms(library, reps, w)[0] + cuda_ms(library, reps, w)[0]) / 2
    return (k1 + k2) / 2, (p1 + p2) / 2, lib, (h1 + h2) / 2


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def bf16_ulps(want, ulps):
    """`ulps` bf16 ulps of the largest |value|: 2^-7 of it each (no floor,
    so outputs well below 1, as attention's, are held at their own scale)."""
    return ulps * 2.0 ** -7 * want.float().abs().max().item()


def row(name, device, got, want, tol, work, *, what="", kernel=None, plain=None,
        library=None, library_what=None, reps=20, rate_unit="TFLOP/s"):
    """One result: the kernel's output `got` against the plain version's
    `want` within `tol`, and on the card the times of the `kernel`, `plain`
    and `library` calls beside the bound of `work` (`ops/bounds.py`'s
    (bytes, operations, peak[, fp32_ops]))."""
    err = max_err(got, want)
    ok = bool(err <= tol and got.shape == want.shape and got.dtype == want.dtype
              and torch.isfinite(got.float()).all())
    b_ms, b_by = bounds.bound(*work)
    r = {"name": name, "what": what, "device": str(device), "err": err, "tol": tol,
         "ok": ok, "bound_ms": b_ms, "bound_by": b_by, "ms": None, "plain_ms": None,
         "library_ms": None, "library": library_what, "host_ms": None,
         "rate": None, "rate_unit": rate_unit}
    if device.type == "cuda" and kernel is not None:
        ms, plain_ms, lib_ms, host_ms = timed(kernel, plain, library, reps)
        r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, host_ms=host_ms,
                 rate=work[1] / ms / 1e9)
    return r


def show(rows):
    """Print the rows, one a line."""
    def fmt(v):
        return "not measured" if v is None else f"{v:.4f}"
    for r in rows:
        rate = "" if r["rate"] is None else f", {r['rate']:.1f} {r['rate_unit']}"
        host = "" if r.get("host_ms") is None else f" (host {r['host_ms']:.4f} ms a call)"
        print(f"{r['name']:28s} {'ok' if r['ok'] else 'FAIL'} err {r['err']:.3e} "
              f"(tol {r['tol']:.2e}); kernel {fmt(r['ms'])} ms{host}{rate}, plain "
              f"{fmt(r['plain_ms'])} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library "
              + (f"{fmt(r['library_ms'])} ms ({r['library']})" if r["library"]
                 else "none"), flush=True)
        if r.get("slope_ms") is not None:
            lo, hi = r["slope_spread_ms"]
            print(f"{'':28s} slope {r['slope_ms']:.4f} ms ({lo:.4f}-{hi:.4f}), "
                  f"{r['slope_rate']:.2f} {r['rate_unit']} (bound "
                  f"{r['slope_bound_ms']:.4f} ms); slope 6 -> 48 "
                  f"{r['slope_6_48_ms']:.4f} ms, plain {r['plain_slope_ms']:.4f} ms",
                  flush=True)


def main(run, description, cpu_shapes, argv=None):
    """`--device` (default cuda), then `run(device)` at the full shapes on
    the card or at `cpu_shapes` on the CPU; prints the card, the rows (then
    all of them as one JSON line), and exits 1 if a row disagrees with its
    plain version."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        print("cpu: the plain versions only, nothing timed", flush=True)
    rows = run(args.device, **({} if dev.type == "cuda" else cpu_shapes))
    show(rows)
    print(json.dumps({"rows": rows}), flush=True)
    if not all(r["ok"] for r in rows):
        raise SystemExit(1)
