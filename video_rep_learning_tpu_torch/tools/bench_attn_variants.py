"""Packed ViT attention at B = 160 (four 40-frame chunks) in the four
variants of the TPU script `tools/bench_attn_variants.py`, on the H100,
each with the exact max-subtracted softmax (`_head_attn`):

- base: exp, two heads a program (`_kernel_grouped`);
- exp2: log2 e folded into the scale;
- allheads: exp2, all heads of an image in one program;
- rowtile: exp2, 256-row query tiles whose key and value tiles are loaded
  once for all 256 rows (`_kernel_rowtile`).

Each is `packed_attention_variant` against its own plain version and each
plain version against the exact fp32 softmax on two images (two bf16 ulps
of the largest output each), beside SDPA on the split heads and the bound, as
`bench_packed_attn.py` does. The TPU script's chained `fori_loop` is not
carried over: CUDA events time the launches themselves.

    python -m video_rep_learning_tpu_torch.tools.bench_attn_variants [--device cpu]
"""

from __future__ import annotations

from . import common
from .bench_packed_attn import attention_rows, make_qkv

B, N, H = 160, 785, 12
CPU_SHAPES = dict(B=2, N=300, H=4)  # N above 256: rowtile's two query tiles
# name: (exp2, nomax, bf16p, heads a block, images a block, query rows a block)
VARIANTS = {
    "base": (False, False, False, 2, 1, 64),
    "exp2": (True, False, False, 2, 1, 64),
    "allheads": (True, False, False, 12, 1, 64),
    "rowtile": (True, False, False, 2, 1, 256),
}


def run(device="cuda", B=B, N=N, H=H, reps=10):
    dev = common.resolve_device(device)
    return attention_rows(dev, make_qkv(B, N, H, dev), H, VARIANTS, False, reps)


if __name__ == "__main__":
    common.main(run, __doc__.splitlines()[0], CPU_SHAPES)
