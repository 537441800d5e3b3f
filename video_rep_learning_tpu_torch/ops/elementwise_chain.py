"""A photometric-shaped elementwise chain repeated `reps` times: the CUDA
kernel, its plain PyTorch version and the wrapper that picks between them
by the device of the tensor.

Counterpart of the TPU micro-benchmark kernel `_chain_kernel`
(`tools/bench_vpu_bf16.py:42`, `chain`), which asks whether bf16
elementwise math runs above the fp32 rate; the kernel is
`csrc/elementwise_chain.cu`. A rep is

    v = clip(v * 1.0001 + 1e-4, 0, 1);  v = where(v > 0.5, v * 0.999, v * 1.001)

in the math type (fp32 or bf16), from an input of either type, returned in
the input's type. The constants round to the math type first, as JAX's weak
types round them: in bf16, 1.0001, 0.999 and 1.001 are all 1.0 and 1e-4 is
1.0014e-4, so the bf16 chain is an add, a clip and a compare whose select
arms are both v. The kernel stays generic in the constants all the same: it
multiplies by them and skips nothing, so the time measures the chain's ops.
No model path takes it.

NaN stays NaN, as `jnp.clip` and `torch.clamp` keep it: the kernel's clip
takes the NaN-keeping min / max (`max.NaN` / `min.NaN`, `__hmax2_nan` /
`__hmin2_nan`), and a NaN fails `v > thr` on both sides; ±inf clips to 1 or
0. Every other value comes out bit for bit as the plain version gives it
(each op rounds once on both sides).

What the kernel issues a rep (its SASS, `tools/sass_loops.py`): 7
instructions a value in fp32 (multiply, add, two NaN-keeping min / max,
compare, select of down or up, multiply) and 6 packed instructions for two
values in bf16 (multiply, the add fused with the max by 0, min, a compare
to a 0xffff-a-half mask, the select as one bitwise op, multiply), which
`OPS_PER_REP`, the bound's count of the TPU script's ops, does not follow.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version, `elementwise_chain_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .plain_grad import use_kernel

CONSTANTS = (1.0001, 1e-4, 0.5, 0.999, 1.001)  # one, eps, thr, down, up
OPS_PER_REP = 8  # mul, add, 2 clip bounds, compare, 2 multiplies, select
# (storage type, math type) -> the kernel's mode
MODES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
         (torch.bfloat16, torch.float32): 2}


@functools.lru_cache(maxsize=None)
def chain_constants(math_dtype):
    """The chain's constants rounded to `math_dtype`, as Python floats."""
    return tuple(torch.tensor(c, dtype=torch.float32).to(math_dtype).item()
                 for c in CONSTANTS)


def elementwise_chain_reference(x, reps, math_dtype):
    """The chain in plain torch, one rounded op at a time."""
    one, eps, thr, down, up = chain_constants(math_dtype)
    v = x.to(math_dtype)
    for _ in range(reps):
        v = torch.clamp(v * one + eps, 0.0, 1.0)
        v = torch.where(v > thr, v * down, v * up)
    return v.to(x.dtype)


def elementwise_chain(x, reps, math_dtype):
    """`reps` reps of the chain over x (fp32 or bf16) in `math_dtype` (fp32,
    or bf16 for a bf16 x), returned in x's type. A CUDA tensor launches
    csrc/elementwise_chain.cu or raises, a CPU tensor takes the plain
    version. `elementwise_chain.launches` counts kernel launches."""
    mode = MODES.get((x.dtype, math_dtype))
    if mode is None:
        raise TypeError(f"storage {x.dtype} with math {math_dtype} not in "
                        f"{sorted((str(a), str(b)) for a, b in MODES)}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if not use_kernel("elementwise_chain", x):
        return elementwise_chain_reference(x, reps, math_dtype)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = cuda_build.kernel_fn("elementwise_chain", "vrl_elementwise_chain",
                              (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,)
                              + (ctypes.c_int,) * 2 + (ctypes.c_float,) * 5
                              + (ctypes.c_void_p,))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), reps, mode,
                 *chain_constants(math_dtype),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch("elementwise_chain", err)
    elementwise_chain.launches += 1
    return out


elementwise_chain.launches = 0
