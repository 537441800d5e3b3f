"""Does the H100 run bf16 elementwise math above the fp32 rate? The port's
counterpart of the TPU script `tools/bench_vpu_bf16.py`: a photometric-shaped
chain (multiply, add, clip, compare, select; `elementwise_chain`,
csrc/elementwise_chain.cu, the counterpart of `_chain_kernel`) run REPS
times over 48 x 512 x 512 values held in registers, in three modes: fp32 in
and fp32 math, bf16 in and bf16 math, bf16 in and fp32 math.

The rate is a slope, as on the TPU: the loads, the stores and the launch
are the same at every count, so the difference of two times is the chain's
own cost. The TPU script's counts, REPS 6 and 48, leave 42 reps, a
difference of about 0.1 ms that moves by a third between runs on the card;
so the rate is the slope between REPS 6 and 480, timed in turns (6, 480,
480, 6) PAIRS times, with its spread over the pairs beside it, and the
6 -> 48 slope is kept as the TPU script's point. Its bound is the reps'
8 operations a value at the peak of the math type (`ops/bounds.py`). In
bf16 the constants 1.0001, 0.999 and 1.001 round to 1.0, so a bf16 rep is
an add, a clip and a compare whose select arms are both v. Each mode's kernel is held
against its plain version at REPS 48 bit for bit (every op rounds once on
both sides), and on `special_values` (NaN, ±inf, values outside [0, 1] and
at the threshold, a count that is no multiple of 8) at REPS 0, 1, 2, 5 and
48: NaN where the plain version has NaN, bit for bit elsewhere. The TPU
script's chained `fori_loop` is not carried over: CUDA events time the
launches themselves, and the slope stays the measurement.

    python -m video_rep_learning_tpu_torch.tools.bench_vpu_bf16 [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bounds
from ..ops.elementwise_chain import (OPS_PER_REP, elementwise_chain,
                                     elementwise_chain_reference)
from . import common

B, S = 48, 512
REPS_LO, REPS_HI = 6, 48  # the TPU script's counts; each mode is checked at 48
REPS_WIDE, PAIRS = 480, 5  # the rate's slope: 6 -> 480, PAIRS times in turns
CPU_SHAPES = dict(B=2, S=16)
MODES = {"fp32 in, fp32 math": (torch.float32, torch.float32),
         "bf16 in, bf16 math": (torch.bfloat16, torch.bfloat16),
         "bf16 in, fp32 math": (torch.bfloat16, torch.float32)}
SPECIAL_REPS = (0, 1, 2, 5, 48)


def special_values(dtype, device="cpu", n=1003):
    """n values of `dtype` (n no multiple of 8): NaN, ±inf, -0.5, 1.5, -0.0,
    the threshold 0.5 and its neighbours, 0 and 1, then uniform draws on
    [-0.25, 1.25)."""
    head = [float("nan"), float("inf"), -float("inf"), -0.5, 1.5, -0.0, 0.5,
            float(np.nextafter(np.float32(0.5), 1)), float(np.nextafter(np.float32(0.5), 0)),
            0.0, 1.0, float("nan")]
    rest = np.random.RandomState(1).rand(n - len(head)).astype(np.float32) * 1.5 - 0.25
    x = torch.from_numpy(np.concatenate([np.float32(head), rest]))
    return x.to(device, dtype)


def same_or_both_nan(got, want):
    """NaN exactly where `want` has NaN, and the same bits everywhere else."""
    nan = torch.isnan(want)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[want.dtype]
    return bool(got.dtype == want.dtype and torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan].view(bits), want[~nan].view(bits)))


def run(device="cuda", B=B, S=S, reps=20):
    dev = common.resolve_device(device)
    x32 = torch.from_numpy(np.random.RandomState(0).rand(B, S, S).astype(np.float32)).to(dev)
    n = x32.numel()
    rows = []
    for name, (store, math) in MODES.items():
        x = x32.to(store)
        kern = {r: (lambda r=r: elementwise_chain(x, r, math)) for r in (REPS_LO, REPS_HI)}
        plain = {r: (lambda r=r: elementwise_chain_reference(x, r, math))
                 for r in (REPS_LO, REPS_HI)}
        work = bounds.elementwise_chain(n, REPS_HI, x.element_size(),
                                        torch.tensor([], dtype=math).element_size())
        r = common.row(name, dev, kern[REPS_HI](), plain[REPS_HI](), 0.0, work,
                       what=f"({B}, {S}, {S}), REPS {REPS_HI}", kernel=kern[REPS_HI],
                       plain=plain[REPS_HI], reps=reps, rate_unit="T ops/s")
        xs = special_values(store, dev)
        r["special_ok"] = all(
            same_or_both_nan(elementwise_chain(xs, n_reps, math),
                             elementwise_chain_reference(xs, n_reps, math))
            for n_reps in SPECIAL_REPS)
        r["ok"] = r["ok"] and r["special_ok"]
        # the slopes: the chain's own cost, the launch and the memory traffic
        # cancelling out
        r["slope_bound_ms"] = bounds.bound(
            0, OPS_PER_REP * n * (REPS_WIDE - REPS_LO), work[2])[0]
        r["slope_ms"] = r["slope_rate"] = r["plain_slope_ms"] = None
        if dev.type == "cuda":
            lo, plain_lo, _, _ = common.timed(kern[REPS_LO], plain[REPS_LO], reps=reps)
            r.update(slope_6_48_ms=r["ms"] - lo, plain_slope_ms=r["plain_ms"] - plain_lo)
            wide = lambda: elementwise_chain(x, REPS_WIDE, math)  # noqa: E731
            slopes = []
            for _ in range(PAIRS):
                l1, h1, h2, l2 = (common.cuda_ms(f, reps)[0]
                                  for f in (kern[REPS_LO], wide, wide, kern[REPS_LO]))
                slopes.append((h1 + h2 - l1 - l2) / 2)
            r.update(slope_ms=sum(slopes) / PAIRS,
                     slope_spread_ms=[min(slopes), max(slopes)])
            r["slope_rate"] = (OPS_PER_REP * n * (REPS_WIDE - REPS_LO)
                               / r["slope_ms"] / 1e9)
        rows.append(r)
    return rows


if __name__ == "__main__":
    common.main(run, __doc__.splitlines()[0], CPU_SHAPES)
