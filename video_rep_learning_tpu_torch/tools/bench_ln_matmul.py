"""LN + matmul + bias + exact GELU at the ViT-B/8 fc1 shape, in the two
schedules of the TPU script `tools/bench_ln_matmul.py`, on the H100:

- jouter: the LN prologue recomputed for every weight column tile
  (`_kernel_jouter`, the (nJ, B) grid). It is also the TPU script's
  "shipped" row;
- scratch: the LN once per image, every column tile reusing it
  (`_kernel_scratch`, the (B, nJ) grid with VMEM scratch);
- #8 + #7: a separate LayerNorm pass, then the matmul + GELU kernel.

Both TPU schedules compute the same function, and both rows run the port's
#6, `ln_matmul_bias_act`: its H100 kernel (csrc/ln_gemm.cu) normalises
each 64-row panel once into shared memory and walks every column tile
from it, whatever the TPU schedule was, so there is no second schedule to
time. Each row against the plain version (the LN rounded to bf16, the
product summed in fp32, the bias and GELU in fp32, rounded once), beside
the library composition `layer_norm + linear + gelu` in bf16 and the bound.
The TPU script's chained `fori_loop` and overhead calibration are not
carried over: CUDA events time the launches themselves (`common.py`).

    python -m video_rep_learning_tpu_torch.tools.bench_ln_matmul [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bounds
from ..ops.layernorm import fused_layernorm
from ..ops.matmul import (ln_matmul_bias_act, ln_matmul_bias_act_reference,
                          matmul_bias_gelu)
from . import common

B, N, K, FO = 40, 785, 768, 3072  # a 40-frame chunk, 785 tokens, fc1 768 -> 3072
CPU_SHAPES = dict(B=2, N=24, K=64, F=256)
# both sides round the same fp32 values at the same points (the LN output,
# the activation): an output may sit one bf16 ulp of the largest value apart
ULPS = 1


def inputs(B, N, K, F, device, seed=0):
    """The TPU script's inputs: x bf16, LN scale and bias fp32, w (K, F) in
    the TPU layout (returned as nn.Linear's (F, K) in bf16), b fp32."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, N, K).astype(np.float32)).to(device, torch.bfloat16)
    g = torch.from_numpy((1 + 0.1 * rng.randn(K)).astype(np.float32)).to(device)
    be = torch.from_numpy((0.1 * rng.randn(K)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.randn(K, F) * 0.03).astype(np.float32))
    b = torch.from_numpy((rng.randn(F) * 0.03).astype(np.float32)).to(device)
    return x, g, be, w.t().contiguous().to(device, torch.bfloat16), b


def run(device="cuda", B=B, N=N, K=K, F=FO, reps=20):
    dev = common.resolve_device(device)
    x, g, be, w, b = inputs(B, N, K, F, dev)
    want = ln_matmul_bias_act_reference(x, g, be, w, b, "gelu_exact")
    gb, beb, bb = g.bfloat16(), be.bfloat16(), b.bfloat16()
    variants = {
        "jouter (#6)": lambda: ln_matmul_bias_act(x, g, be, w, b, "gelu_exact"),
        "scratch (#6)": lambda: ln_matmul_bias_act(x, g, be, w, b, "gelu_exact"),
        "#8 + #7": lambda: matmul_bias_gelu(fused_layernorm(x, g, be), w, b),
    }
    rows = []
    for name, kernel in variants.items():
        rows.append(common.row(
            name, dev, kernel(), want, common.bf16_ulps(want, ULPS),
            bounds.ln_matmul(B * N, K, F, 2, activation="gelu_exact"),
            what=f"({B}, {N}, {K}) -> {F} bf16", kernel=kernel,
            plain=lambda: ln_matmul_bias_act_reference(x, g, be, w, b, "gelu_exact"),
            library=lambda: library_call(x, gb, beb, w, bb),
            library_what="layer_norm + linear + gelu, bf16", reps=reps))
    return rows


def library_call(x, g, be, w, b):
    """The same function as one bf16 composition of PyTorch calls."""
    return F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), g, be, 1e-6), w, b))


if __name__ == "__main__":
    common.main(run, __doc__.splitlines()[0], CPU_SHAPES)
