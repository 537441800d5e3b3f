"""Packed ViT attention at the in-model call shape (40 frames x 785 tokens
x 12 heads of 64, bf16), in the variants of the TPU script
`tools/bench_packed_attn.py`, on the H100:

- shipped: the port's #4, `packed_vit_attention` (exact max-subtracted
  softmax, online over key tiles);
- the `build_variant` forms (`_kernel_var`): exp2 (log2 e folded into the
  scale), nomax+exp2 (the max-free `exp2(min(s, 110))`), allh+nomax (all
  six head pairs in one program: 12 heads a block);
- the `build_multi` forms (`_kernel_multi_img`, always max-free exp2, all
  heads): img2, img4 (images a block), img2+bf16p and img1+bf16p (l summed
  over p rounded to bf16).

Every variant is `packed_attention_variant` (csrc/packed_attn_variants.cu)
held against its own plain version, which rounds as the variant does (two
bf16 ulps of the largest output: the max-subtracted forms round p against a
running max in the kernel and the full-row max in the plain version), and
each plain version against the exact fp32 softmax on the first two images
(two bf16 ulps of the exact output's largest value: the plain version
rounds P and its output to bf16). The outputs are means of 785 values of
0.3 randn, of order 0.01-0.06, so every limit is taken at their own scale,
not at 1. Beside them: SDPA on the split heads as the library call, the bound.
The TPU script's chained `fori_loop` and overhead calibration are not
carried over: CUDA events time the launches themselves (`common.py`).

    python -m video_rep_learning_tpu_torch.tools.bench_packed_attn [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bounds
from ..ops.attention import (packed_attention_reference,
                             packed_attention_variant,
                             packed_attention_variant_reference,
                             packed_vit_attention)
from . import common

B, N, H, DH = 40, 785, 12, 64
CPU_SHAPES = dict(B=2, N=24, H=4)
ULPS = 2  # the kernel against its own variant's plain version, as #4
EXACT_ULPS = 2  # each plain version against the exact fp32 softmax
# name: (exp2, nomax, bf16p, heads a block, images a block), the TPU main()'s
# list; heads a block 12 means all heads (H at another shape)
VARIANTS = {
    "exp2": (True, False, False, 2, 1),
    "nomax+exp2": (True, True, False, 2, 1),
    "allh+nomax": (True, True, False, 12, 1),
    "img2": (True, True, False, 12, 2),
    "img4": (True, True, False, 12, 4),
    "img2+bf16p": (True, True, True, 12, 2),
    "img1+bf16p": (True, True, True, 12, 1),
}


def make_qkv(B, N, H, device, seed=0):
    """The TPU script's input: 0.3 * randn, bf16."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(B, N, 3 * H * DH) * 0.3).astype(np.float32)).to(
        device, torch.bfloat16)


def split_heads(qkv, H):
    """(3, B, H, N, dh) views of the packed qkv for SDPA."""
    B_, N_ = qkv.shape[:2]
    return qkv.view(B_, N_, 3, H, DH).permute(2, 0, 3, 1, 4).contiguous()


def attention_rows(dev, qkv, H, variants, shipped, reps):
    """One row a variant (and #4's when `shipped`): kernel against its own
    plain version, each plain version against the exact fp32 softmax on two
    images."""
    B_, N_ = qkv.shape[:2]
    work = bounds.packed_attention(B_, N_, H * DH, H, 2)
    exact = packed_attention_reference(qkv[:2].float(), H)
    split = split_heads(qkv, H) if dev.type == "cuda" else None
    library = None if split is None else (lambda: F.scaled_dot_product_attention(*split))
    rows = []
    cases = {}
    if shipped:
        cases["shipped (#4)"] = (lambda: packed_vit_attention(qkv, H),
                                 lambda: packed_attention_reference(qkv, H))
    for name, (exp2, nomax, bf16p, hpb, ipb, *bq) in variants.items():
        flags = dict(exp2=exp2, nomax=nomax, bf16p=bf16p)
        sched = dict(block_q=bq[0] if bq else 64, heads_per_block=min(hpb, H),
                     images_per_block=ipb)
        cases[name] = (
            lambda f=flags, s=sched: packed_attention_variant(qkv, H, **f, **s),
            lambda f=flags: packed_attention_variant_reference(qkv, H, **f))
    for name, (kernel, plain) in cases.items():
        want = plain()
        r = common.row(name, dev, kernel(), want, common.bf16_ulps(want, ULPS), work,
                       what=f"({B_}, {N_}, {3 * H * DH}) bf16", kernel=kernel,
                       plain=plain, library=library,
                       library_what="scaled_dot_product_attention, split heads",
                       reps=reps)
        r["exact_err"] = common.max_err(want[:2], exact)
        r["exact_tol"] = common.bf16_ulps(exact, EXACT_ULPS)
        r["ok"] = r["ok"] and r["exact_err"] <= r["exact_tol"]
        rows.append(r)
        del want
    return rows


def run(device="cuda", B=B, N=N, H=H, reps=20):
    dev = common.resolve_device(device)
    return attention_rows(dev, make_qkv(B, N, H, dev), H, VARIANTS, True, reps)


if __name__ == "__main__":
    common.main(run, __doc__.splitlines()[0], CPU_SHAPES)
