"""Least times on one NVIDIA H100 SXM for the work of each TPU kernel of the
JAX package: the larger of the bytes its function must move (each input
read once, each output written once) over the memory rate, and its
operations over the peak rate for their type (the card's published dense
peaks: 3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16
in them; 700 W). `chip_smoke.py` uses `bound` for the kernels it times; this
script prints the table for every row at the shapes its workload gives it:

    python -m video_rep_learning_tpu_torch.ops.bounds
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16_TC = 989e12


def bound(nbytes, flops, peak_flops=PEAK_FP32, fp32_ops=0):
    """(bound_ms, "bytes" | "operations"): `flops` at `peak_flops` (a
    product's operations at the tensor-core or fp32 rate) plus `fp32_ops`
    elementwise operations outside the tensor cores at the fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak_flops + fp32_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _peak(itemsize):
    """The product's peak: bf16 on the tensor cores, fp32 outside them."""
    return PEAK_BF16_TC if itemsize == 2 else PEAK_FP32


# elementwise operations of the ViT kernels: a LayerNorm 8 a value (the
# sum, the centred square and its sum, subtract, scale by the rstd, the
# affine multiply-add); an epilogue's bias add 1, the activation (erf or tanh
# counted as one) 4 for the exact GELU and 7 for the tanh form, a residual
# add 1; the softmax 5 a score (scale, max, subtract, exp, sum)
LN_OPS = 8
ACT_OPS = {"none": 0, "gelu_exact": 4, "gelu_tanh": 7}
SOFTMAX_OPS = 5


def layernorm(rows, D, itemsize):
    """#8: (nbytes, flops, peak, fp32_ops) of LayerNorm over (rows, D): x in,
    y out, fp32 scale and bias; all its work is elementwise."""
    return itemsize * 2 * rows * D + 4 * 2 * D, 0, PEAK_FP32, LN_OPS * rows * D


def ln_matmul(rows, K, F, itemsize, ln=True, activation="none", residual=False):
    """#6 (and #5's projection): act(LN(x) W^T + b) [+ r] for x (rows, K),
    W (F, K): x, W, fp32 b (and LN parameters, residual) in, y out."""
    nbytes = (itemsize * (rows * K + F * K + rows * F * (2 if residual else 1))
              + 4 * (F + (2 * K if ln else 0)))
    fp32_ops = ((LN_OPS * rows * K if ln else 0)
                + rows * F * (1 + ACT_OPS[activation] + (1 if residual else 0)))
    return nbytes, 2 * rows * K * F, _peak(itemsize), fp32_ops


def mlp_block(rows, K, F, itemsize, activation="gelu_exact"):
    """#9: x + act(LN(x) W1^T + b1) W2^T + b2 for x (rows, K), W1 (F, K),
    W2 (K, F): x, both weights, fp32 LN parameters and biases in, y out (the
    (rows, F) activation never leaves the chip). Operations: fc1 and fc2,
    the LN, fc1's bias and activation, fc2's bias and residual."""
    nbytes = itemsize * (2 * rows * K + 2 * F * K) + 4 * (3 * K + F)
    fp32_ops = (LN_OPS * rows * K + rows * F * (1 + ACT_OPS[activation])
                + 2 * rows * K)
    return nbytes, 4 * rows * K * F, _peak(itemsize), fp32_ops


def packed_attention(n, N, D, heads, itemsize):
    """#4: (n, N, 3D) qkv in, (n, N, D) out; q k^T and P V of every head
    (4 N^2 D a frame) and the softmax over n heads N^2 scores."""
    return (itemsize * 4 * n * N * D, 4 * n * N * N * D, _peak(itemsize),
            SOFTMAX_OPS * n * heads * N * N)


def vit_attention_block(n, N, D, heads, itemsize):
    """#5, the TPU kernel's single pass: x and the weights in, y out; the qkv
    and the attention output never leave the chip. Operations: the qkv and
    projection products, attention, the LN, the softmax and the epilogues."""
    rows = n * N
    nbytes = itemsize * (2 * rows * D + 4 * D * D) + 4 * (2 * D + 4 * D)
    flops = 2 * rows * D * 4 * D + 4 * n * N * N * D
    fp32_ops = (LN_OPS * rows * D + SOFTMAX_OPS * n * heads * N * N
                + rows * 3 * D + 2 * rows * D)
    return nbytes, flops, _peak(itemsize), fp32_ops


def attention_fwd(B, H, S, d, itemsize=4, keys=None):
    """q, k, v, mask in; out, lse out; QK^T and PV over the `keys` unmasked
    (batch row, key) pairs (default all B * S)."""
    n = B * H * S * d
    keys = B * S if keys is None else keys
    return itemsize * 4 * n + 4 * (B * S + B * H * S), 4 * H * S * keys * d


def attention_bwd(B, H, S, d, itemsize=4, keys=None):
    """q, k, v, out, dO, lse, mask in; dq, dk, dv out; s recomputed, dp, dv,
    dq, dk: five products over the unmasked keys, as `attention_fwd`."""
    n = B * H * S * d
    keys = B * S if keys is None else keys
    return itemsize * 8 * n + 4 * (B * S + B * H * S), 10 * H * S * keys * d


# per-pair elementwise operations of the fused SCL passes, the least each
# needs (fp32, outside the tensor cores; exp, log and a divide count one),
# split into what every pair with a negative weight or a positive label needs
# and what only a positive pair needs (cross view, both frames unmasked: the
# label is 0 elsewhere, and so are the loss and S terms). Every pair: the
# logit's scale and exp 2, the pair terms (mask product, two compares, three
# selects) 6, then rowsum's w exp and add 2, the gradient's term 1 4. A
# positive: the gaussian (divide, multiply, subtract, abs, mask select,
# square, scale, exp, cross select) 9; the possum add 1; the loss term
# (label divide and NaN select 2, log input 3, x log x 3, the KL's multiply,
# subtract, select and add 4) 12; the S term (r, c 3, label 1, product and
# add 3) 7; the gradient's term 2 (the IJ one on the S term's r, c and label
# 4; the JI one with its transposed gaussian 9, r, c 3 and label and
# product 4) 20 beside the S term's 7. The loss and S passes need the logit
# only at a positive pair. {pass: (a pair, a positive)}
SCL_OPS = {"rowsum": (8 + 2, 9 + 1), "loss": (0, 8 + 9 + 12), "srow": (0, 8 + 9 + 7),
           "grad": (8 + 4, 9 + 7 + 20), "forward": (8 + 2, 9 + 1 + 12),
           "backward": (8 + 4, 9 + 7 + 20)}


def scl_fused(N, C, pairs=None, positives=None):
    """#10: {pass or "forward" / "backward": (nbytes, flops, peak, fp32_ops)}
    of the fused SCL loss over N frames of C channels (fp32). `pairs` counts
    the (i, j) pairs with a negative weight or a positive label (default all
    N^2), `positives` those of them whose label can be nonzero (default
    `pairs`); `ops/scl.py`'s `work_pairs` gives both. The logits (2 C flops a
    pair) are needed over `pairs` by passes 1 and 4, over `positives` by 2
    and 3; the forward needs them once, the backward the logits and the
    product (G + G^T) e, nonzero over `pairs`, once each. Bytes: e and the
    (8, N) metadata in, the per-row values (or the gradient) out."""
    pairs = N * N if pairs is None else pairs
    positives = pairs if positives is None else positives
    logits = {k: 2 * C * (positives if k in ("loss", "srow") else pairs)
              for k in SCL_OPS}
    logits["grad"] += 2 * C * pairs
    logits["backward"] += 2 * C * pairs
    e_meta = 4 * (N * C + 8 * N)
    out = {"rowsum": 2 * 4 * N, "loss": 4 * N, "srow": 4 * N, "grad": 4 * N * C,
           "forward": 4, "backward": 4 * N * C}
    rows_in = {"rowsum": 0, "loss": 2 * 4 * N, "srow": 2 * 4 * N, "grad": 3 * 4 * N,
               "forward": 0, "backward": 2 * 4 * N}
    return {k: (e_meta + rows_in[k] + out[k], logits[k], PEAK_FP32,
                a_pair * pairs + a_positive * positives)
            for k, (a_pair, a_positive) in SCL_OPS.items()}


# operations per output pixel of the photometric chain: the least its
# function needs, whatever order a kernel computes it in (fp32, outside the
# tensor cores; an add, multiply, min, max, compare, select or divide is one,
# a multiply-add two). The jitter ops from the plain version's formulas:
# brightness (scale, clamp: 9), contrast (luma, its mean, blend, clamp: 18),
# saturation (luma, blend, clamp: 18), hue (clamp, max / min, the sextant's
# difference, the shift and the rebuild from v, p, q, t: 44). The gaussian
# blur is separable: 9 taps down and 5 across, of 3 channels. Grayscale is
# the luma; normalisation a multiply-add a channel.
JITTER_OPS = 9 + 18 + 18 + 44
BLUR_OPS = 2 * (9 + 5) * 3
GRAY_OPS, NORM_OPS = 5, 6
TAP2_OPS = 3  # a 2-tap weighted sum: a multiply and a multiply-add


def crop_ops(S, rows, cols):
    """Operations of the separable crop-resample to S x S of 3 channels,
    whose resample rows have two taps: a pass over the source lines the crop
    reads (its `rows` of the canvas, or its `cols`, whichever are fewer),
    then a pass over the output."""
    return 3 * TAP2_OPS * S * (S + min(rows, cols))


def photometric_flops(fscal, T, S, rh=None, rw=None):
    """The operations a batch of views needs, by each view's flags (fscal
    (BV, 8): jitter column 0, blur 5, gray 6) and, for the crop, by the
    source lines its resample matrices rh (BV, S, H) and rw (BV, W, S) read
    (None: no crop)."""
    f = fscal.float().cpu()
    per_px = (NORM_OPS + JITTER_OPS * f[:, 0] + BLUR_OPS * f[:, 5]
              + GRAY_OPS * f[:, 6])
    total = float(per_px.sum()) * T * S * S
    if rh is not None:
        rows = (rh != 0).any(dim=1).sum(-1).tolist()
        cols = (rw != 0).any(dim=2).sum(-1).tolist()
        total += T * sum(crop_ops(S, r, c) for r, c in zip(rows, cols))
    return total


def table():
    """(row, shape, bytes, flops, peak[, fp32_ops]) of every TPU kernel at
    its workload's shape."""
    B, V, T, S, H_, W_ = 1, 2, 240, 224, 256, 256  # CARL training step
    frames = B * V * T
    # MV-Former's ViT-B/8 frame backbone at 224 px: 785 tokens of 768, 12
    # heads of 64, bf16, in chunks of 40 frames (MODEL.BASE_MODEL.FRAMES_PER_BATCH)
    n, N, D, Hh = 40, 785, 768, 12
    rows = [
        ("#1/#2 flash fwd", "(2, 8, 240, 32) fp32",
         *attention_fwd(2, 8, 240, 32), PEAK_FP32),
        ("#3 flash bwd", "(2, 8, 240, 32) fp32",
         *attention_bwd(2, 8, 240, 32), PEAK_FP32),
        ("#4 packed MHA", "(40, 785, 2304) bf16",
         *packed_attention(n, N, D, Hh, 2)),
        ("#5 ViT attention half-block", "(40, 785, 768) bf16",
         *vit_attention_block(n, N, D, Hh, 2)),
        ("#6 LN + matmul + GELU", "(40, 785, 768) -> 3072 bf16",
         *ln_matmul(n * N, D, 4 * D, 2, activation="gelu_exact")),
        ("#7 matmul + GELU", "(40, 785, 768) -> 3072 bf16",
         *ln_matmul(n * N, D, 4 * D, 2, ln=False, activation="gelu_exact")),
        ("#8 LayerNorm", "(40, 785, 768) bf16", *layernorm(n * N, D, 2)),
        ("#9 LN + MLP + residual", "(40, 785, 768), F 3072 bf16",
         *mlp_block(n * N, D, 4 * D, 2)),
        # the partially frozen ViT's trainable tail runs on all the frames of
        # a step at once: 1 clip x 2 views x 240
        ("#9 LN + MLP + residual", "(480, 785, 768), F 3072 bf16",
         *mlp_block(480 * N, D, 4 * D, 2)),
        # the loss and its gradient over all N x N similarities of 128-d
        # embeddings, at N = 18 x 2 x 240 (the auto gate's reach)
        ("#10 SCL loss (forward)", "(8640, 128) fp32",
         *scl_fused(8640, 128)["forward"]),
        ("#10 SCL gradient (backward)", "(8640, 128) fp32",
         *scl_fused(8640, 128)["backward"]),
        # with every op of the chain on, and a crop that reads every line of
        # the canvas (RandomResizedCrop takes 80-100% of its area);
        # chip_smoke.py's bounds count the flags and boxes its views drew
        ("#11 photometric", f"({V}, {T}, 3, {S}, {S}) fp32",
         4 * 2 * frames * 3 * S * S,
         (JITTER_OPS + BLUR_OPS + GRAY_OPS + NORM_OPS) * frames * S * S, PEAK_FP32),
        ("#12 crop + photometric", f"({V}, {T}, 3, {H_}, {W_}) uint8 -> bf16",
         frames * 3 * H_ * W_ + 2 * frames * 3 * S * S,
         (JITTER_OPS + BLUR_OPS + GRAY_OPS + NORM_OPS) * frames * S * S
         + frames * crop_ops(S, H_, W_), PEAK_FP32),
    ]
    return rows


def main():
    print("H100 SXM bounds (3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16 "
          "tensor cores; 700 W)")
    for name, shape, nbytes, flops, peak, *fp32_ops in table():
        ms, by = bound(nbytes, flops, peak, *fp32_ops)
        print(f"{name:30s} {shape:34s} {nbytes / 1e6:10.2f} MB "
              f"{flops / 1e9:10.3f} GFLOP  bound {ms:.4f} ms ({by})")


if __name__ == "__main__":
    main()
