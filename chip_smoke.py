#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
drives the CARL embedding and training paths and the MV-Former embedding
path end to end at full model width, and compares the card with the CPU on
each.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc builds every `video_rep_learning_tpu_torch/csrc/*.cu`, one
   compiler per source, all at once;
3. kernel vs plain, and times beside the plain version, the bound and the
   library call where there is one:
   - flash-attention forward and backward in fp32 and bf16 at the CARL
     shapes, a long key range, padded keys and a fully masked row;
   - crop+photometric and photometric at the CARL training shape
     (2 views x 240 frames of 256x256 uint8 -> 224), every flag, blur sigma
     0.1 and 2.0, a padded canvas, fp32 and bf16 output;
   - the ViT kernels (LayerNorm, LN + matmul + bias + activation with each
     activation and with the residual epilogue, packed attention, the
     attention half-block) in fp32 and bf16 at the MV-Former chunk
     (40 x 785 x 768) and a ragged last chunk (7 frames);
4. eval path: `python -m video_rep_learning_tpu_torch.evaluate`'s function on
   a synthetic Pouring set with a full-width CARL model (seeded weights) and
   the kendalls_tau + retrieval tasks; checks launches, finiteness, unit
   norm and frame counts; reports frames/s;
5. training path: `python -m video_rep_learning_tpu_torch.train`'s function,
   one epoch over the 6 train videos and a checkpoint, then
   `--continue_train` for a second epoch from it; checks the loss, which
   parameters moved, the kernels' launches; reports warm ms per step and
   clips/s, and profiles one warm step;
6. card vs CPU: one 96-frame video through the eval path, and one training
   step in fp32 (the path of the photometric-only kernel), same weights and
   same sampled augmentation on both, with layer4 checked once more in fp64;
7. MV-Former eval path: the same evaluation function on
   `configs_mvf/pouring_mvf.yml` (fully frozen ViT-B/8 at 224 px, bf16, 3
   LSTP tokens, a 3-layer encoder; seeded weights saved as a checkpoint)
   over the synthetic set; checks the ViT kernels' and the encoder's
   launches and the embeddings; reports warm frames/s; then 16 frames of
   one video in fp32, card vs CPU.

The last two lines of stdout are a JSON object with one entry per kernel,
then `{"ok": true, "device": {...}}`. Work files go to `build/chip_smoke/`.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
CFG_FILE = os.path.join(REPO, "configs", "scl_transformer_config.yml")
MVF_CFG_FILE = os.path.join(REPO, "configs_mvf", "pouring_mvf.yml")
SEED = 0
# the CARL eval path gives the encoder (1, 8, n, 32) fp32 with n <= 1000
CARL_TIMING_SHAPES = [(1, 8, 240, 32), (1, 8, 1000, 32)]
# and the training path (2 views, 8 heads, 240 frames, 32) fp32
TRAIN_ATTN_SHAPE = (2, 8, 240, 32)
TOL = {  # max |kernel - plain(fp32)|
    # fp32: the same fp32 math summed in another order
    (torch.float32, "out"): 1e-5, (torch.float32, "lse"): 1e-4,
    # bf16: the kernel's output is rounded to bf16 (half an ulp is 2^-9 of
    # |out| <= ~4); its LSE stays fp32
    (torch.bfloat16, "out"): 1.6e-2, (torch.bfloat16, "lse"): 1e-4,
}
CARD_VS_CPU_TOL = 1e-3  # unit-norm embeddings, fp32 on both, TF32 off
# flash backward, max |kernel - plain| over each gradient tensor, relative to
# its largest value (at least 1). fp32: the same fp32 math summed in another
# order over up to 6000 keys. bf16: the kernel rounds dq, dk, dv to bf16 (an
# ulp of |g| < 4 is 2^-6), and p and ds to bf16 before their products, as
# the plain version does, so a value near a rounding boundary may land one
# ulp apart
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}
# augmentation, max |kernel - plain| in normalised units. fp32: the same fp32
# math in another order (the resample and blur sums, the contrast mean), then
# /0.224, far under one uint8 level (1 / 255 / 0.224 = 0.0175). bf16 output:
# one bf16 ulp of |x| < 4 (2^-6), since the fp32 values may sit either side
# of a rounding boundary
AUG_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# one fp32 training step, card vs CPU (TF32 off on the card), over frames
# that differ in colour and contrast: frames in normalised units (as
# AUG_TOL); the loss relative; each gradient tensor of the head (FC+BN,
# encoder, embedding, projection) relative to its largest value (at least
# 1), 2e-3: the same fp32 math summed in another order. fp32 does not
# determine layer4's gradients that far at the seeded random weights: the
# CPU's own fp32 layer4 gradients lie up to ~1e-1 of their largest value
# from its fp64 ones on the same inputs (printed every run, with the card's).
# So layer4 is held in fp64: its forward and backward on the CPU step's
# layer3 features and upstream gradient, card vs CPU, to 1e-8 (fp64
# rounding, 2^-53, times the ~1e6 by which fp32 shows these sums amplify
# rounding: ~1e-10)
STEP_TOL = {"frames": 1e-4, "loss": 1e-4, "grads": 2e-3, "layer4_fp64": 1e-8}
# the ViT kernels, max |kernel - plain| on the same inputs. fp32: the same
# fp32 math summed in another order (up to 768 products a sum, values of
# order 1-10). bf16: both sides round the same fp32 values at the same
# points, so an output may sit one ulp apart (2^-7 of the largest value);
# attention rounds p unnormalised in the kernel, normalised in the plain
# version (two ulps); the half-block composes three rounded stages, the
# last one (proj + residual) rounding once from fp32 (two)
VIT_FP32_TOL = {"layernorm": 1e-5, "ln_gemm": 1e-4, "packed_attn": 1e-5,
                "vit_attention_block": 1e-4}
VIT_BF16_ULPS = {"layernorm": 1, "ln_gemm": 1, "packed_attn": 2,
                 "vit_attention_block": 2}
VIT_SHAPES = [(40, 785, 768), (7, 785, 768)]  # a chunk, a ragged last chunk
MVF_CARD_VS_CPU = 16  # frames; fp32, TF32 off, 12 blocks: tol CARD_VS_CPU_TOL


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment():
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    """One nvcc per source, all started together."""
    from video_rep_learning_tpu_torch.ops import cuda_build

    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(cuda_build.build, names)))
    log(f"build {', '.join(names)}: {time.time() - t0:.2f} s in parallel")
    for name, so in libs.items():
        log_path = so.with_name(so.name + ".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: " + line.strip())


def make_synthetic_set():
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    data = os.path.join(WORK, "data", "pouring")
    shutil.rmtree(WORK, ignore_errors=True)
    make_pouring(data, num_train=6, num_val=6, min_len=150, max_len=600,
                 size=256, seed=SEED)
    lens = []
    for split in ("train", "val"):
        with open(os.path.join(data, f"{split}.pkl"), "rb") as f:
            lens += [int(e["seq_len"]) for e in pickle.load(f)]
    log(f"synthetic Pouring set: 6 train + 6 val npy videos at 256x256, "
        f"lengths {lens}, {sum(lens)} frames")
    return os.path.dirname(data), lens


def phase_kernel_vs_plain(main_lens):
    """Every case goes through the wrapper on CUDA tensors and through
    `attention_reference` in fp32 on the same (bf16-rounded) values."""
    from video_rep_learning_tpu_torch.ops.attention import (
        attention_reference, flash_attention_fwd)

    g = torch.Generator().manual_seed(SEED)
    cases = [(1, 8, s, 32) for s in (37, 128, 240, 600, 1000)]
    cases += [(2, 8, 240, 32), (1, 8, 6000, 32), (2, 12, 785, 64)]
    cases += sorted({(1, 8, n, 32) for n in main_lens})
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            B, H, S, d = shape
            q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
                       for _ in range(3))
            masked = shape not in [(1, 8, n, 32) for n in main_lens]
            mask = None
            if masked:  # padded tail keys, plus a fully masked batch row
                mask = (torch.rand(B, S, generator=g) > 0.1).float()
                mask[:, S - S // 8:] = 0
                if B > 1:
                    mask[1] = 0
                mask = mask.cuda()
            out, lse = flash_attention_fwd(q, k, v, mask, d ** -0.5)
            torch.cuda.synchronize()
            r_out, r_lse = attention_reference(q.float(), k.float(), v.float(),
                                               mask, d ** -0.5)
            e_out = (out.float() - r_out).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            ok = (e_out <= TOL[(dtype, "out")] and e_lse <= TOL[(dtype, "lse")]
                  and bool(torch.isfinite(out.float()).all()))
            log(f"kernel vs plain {str(dtype)[6:]:8s} {shape} "
                f"{'masked' if masked else 'no mask'}: out err {e_out:.3e} "
                f"(tol {TOL[(dtype, 'out')]:.1e}), lse err {e_lse:.3e} "
                f"(tol {TOL[(dtype, 'lse')]:.1e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attn_fwd disagrees at {shape} {dtype}")
            if dtype == torch.float32 and not masked:
                main_err = max(main_err, e_out)

    for shape in CARL_TIMING_SHAPES:
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        scale = shape[-1] ** -0.5
        kern = lambda: flash_attention_fwd(q, k, v, None, scale)  # noqa: E731
        plain = lambda: attention_reference(q, k, v, None, scale)  # noqa: E731
        # alternate plain, kernel, kernel, plain: both see the same clocks
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
        log(f"time {shape} fp32 no mask: flash_attn_fwd kernel "
            f"{(k1 + k2) / 2:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
            f"attention_reference {(p1 + p2) / 2:.4f} ms ({p1:.4f}, {p2:.4f})")
    return main_err


def timed(kern, plain, library=None):
    """Kernel, plain and library times in turns (plain, kernel, kernel, plain,
    then the library call twice), each the mean of its two runs."""
    p1, k1, k2, p2 = (cuda_ms(f, reps=20) for f in (plain, kern, kern, plain))
    lib = None if library is None else (cuda_ms(library, reps=20)
                                        + cuda_ms(library, reps=20)) / 2
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def phase_attention_backward():
    """flash_attn_bwd against `attention_backward_reference` on the same
    forward outputs, then the training-shape times of both directions."""
    import torch.nn.functional as F

    from video_rep_learning_tpu_torch.ops.attention import (
        attention_backward_reference, attention_reference, flash_attention_bwd,
        flash_attention_fwd)
    from video_rep_learning_tpu_torch.ops.bounds import (attention_bwd,
                                                         attention_fwd, bound)

    g = torch.Generator().manual_seed(SEED + 1)
    cases = [(2, 8, 240, 32), (1, 8, 1000, 32), (1, 8, 6000, 32), (2, 4, 200, 64)]
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            B, H, S, d = shape
            q, k, v, dout = (torch.randn(shape, generator=g).to("cuda", dtype)
                             for _ in range(4))
            mask = (torch.rand(B, S, generator=g) > 0.1).float()
            mask[:, S - S // 8:] = 0  # padded keys
            if B > 1:
                mask[1] = 0  # a batch row that attends to nothing
            mask = mask.cuda()
            out, lse = flash_attention_fwd(q, k, v, mask, d ** -0.5)
            got = flash_attention_bwd(q, k, v, mask, out, lse, dout, d ** -0.5)
            torch.cuda.synchronize()
            want = attention_backward_reference(q, k, v, mask, out, lse, dout,
                                                d ** -0.5)
            errs = [(a.float() - b.float()).abs().max().item()
                    / max(1.0, b.float().abs().max().item())
                    for a, b in zip(got, want)]
            ok = max(errs) <= BWD_TOL[dtype] and all(
                bool(torch.isfinite(a.float()).all()) for a in got)
            log(f"kernel vs plain flash_attn_bwd {str(dtype)[6:]:8s} {shape} "
                f"masked: dq/dk/dv err {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
                f"(tol {BWD_TOL[dtype]:.1e} of max|g|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attn_bwd disagrees at {shape} {dtype}")
            if dtype == torch.float32 and shape == TRAIN_ATTN_SHAPE:
                main_err = max(errs)

    # the training path's shape: (2 views, 8 heads, 240 frames, 32) fp32
    B, H, S, d = TRAIN_ATTN_SHAPE
    q, k, v, dout = (torch.randn(TRAIN_ATTN_SHAPE, generator=g).cuda()
                     for _ in range(4))
    mask = torch.ones(B, S, device="cuda")
    mask[:, S - S // 8:] = 0
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, mask, scale)
    entries = {}
    ms, plain_ms, lib_ms = timed(
        lambda: flash_attention_fwd(q, k, v, mask, scale),
        lambda: attention_reference(q, k, v, mask, scale),
        lambda: F.scaled_dot_product_attention(q, k, v))
    keys = int(mask.sum())  # the masked keys need no work
    b_ms, b_by = bound(*attention_fwd(B, H, S, d, keys=keys))
    entries["flash_attn_fwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg).backward(dout)

    ms, plain_ms, lib_ms = timed(
        lambda: flash_attention_bwd(q, k, v, mask, out, lse, dout, scale),
        lambda: attention_backward_reference(q, k, v, mask, out, lse, dout, scale),
        sdpa_fwd_bwd)
    b_ms, b_by = bound(*attention_bwd(B, H, S, d, keys=keys))
    entries["flash_attn_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms,
                                     max_abs_err=main_err)
    for name, e in entries.items():
        log(f"time {TRAIN_ATTN_SHAPE} fp32 masked: {name} kernel {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}), library (scaled_dot_product_attention, no mask"
            f"{', fwd+bwd' if name.endswith('bwd') else ''}) {e['library_ms']:.4f} ms")
    return entries


def _sampled(gen, BV, H, W, S, dims=None):
    from video_rep_learning_tpu_torch.ops.augment import (AugmentParams,
                                                          sample_ssl_batch)

    s = sample_ssl_batch(gen, BV // 2, 2, H, W, dims, AugmentParams(image_size=S))
    return {k: t.cuda() for k, t in s.items()}


def phase_augment():
    """crop_photometric and photometric against their plain versions: every
    flag combination (16 views, one per combination) with blur sigma 0.1 and
    2.0 and the four contrast positions, on a padded canvas; then the
    training shape with sampled values, checked and timed."""
    from video_rep_learning_tpu_torch.ops.bounds import bound, photometric_flops
    from video_rep_learning_tpu_torch.ops.photometric import (
        crop_photometric, crop_photometric_reference, photometric,
        photometric_reference)

    g = torch.Generator().manual_seed(SEED + 2)
    S = 224
    max_err = {"crop_photometric": 0.0, "photometric": 0.0}

    def check(name, got, want, dtype, what):
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= AUG_TOL[dtype] and bool(torch.isfinite(got.float()).all())
        log(f"kernel vs plain {name} {str(dtype)[6:]:8s} {what}: err {err:.3e} "
            f"(tol {AUG_TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees ({what}, {dtype})")
        if dtype == torch.float32:
            max_err[name] = max(max_err[name], err)

    # every flag combination, on a canvas whose true extent is smaller
    BV, T, H, W = 16, 6, 256, 256
    s = _sampled(g, BV, H, W, S, dims=[[200, 240]] * (BV // 2))
    combos = torch.tensor([[(i >> b) & 1 for b in range(4)] for i in range(BV)],
                          dtype=torch.float32)
    s["fscal"][:, [0, 5, 6, 7]] = combos.cuda()
    s["orders"] = torch.stack([torch.roll(torch.tensor([1, 0, 2, 3]), i % 4)
                               for i in range(BV)]).to("cuda", torch.int32)
    from video_rep_learning_tpu_torch.ops.augment import ssl_matrices

    sig = torch.tensor([0.1, 2.0] * (BV // 2))
    s.update({k: t.cuda() for k, t in ssl_matrices(s["boxes"].cpu(), sig, H, W,
                                                   S).items()})
    videos = torch.randint(0, 256, (BV, T, 3, H, W), generator=g,
                           dtype=torch.uint8).cuda()
    videos[..., 200:, :] = 0
    videos[..., 240:] = 0
    x = torch.rand(BV, T, 3, S, S, generator=g).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        args = (videos, s["rh"], s["rw"], s["fscal"], s["orders"], s["mh"], s["mw"])
        check("crop_photometric", crop_photometric(*args, out_dtype=dtype),
              crop_photometric_reference(*args, out_dtype=dtype), dtype,
              "16 flag combinations, sigma 0.1/2.0, padded canvas")
        args = (x, s["fscal"], s["orders"], s["mh"], s["mw"])
        check("photometric", photometric(*args, out_dtype=dtype),
              photometric_reference(*args, out_dtype=dtype), dtype,
              "16 flag combinations, sigma 0.1/2.0")

    # the training shape: 2 views x 240 frames, 256x256 uint8 -> 224
    BV, T = 2, 240
    entries = {}
    s = _sampled(g, BV, H, W, S)
    s["fscal"][:, 0] = 1  # jitter on in both views: the contrast pre-pass runs
    videos = torch.randint(0, 256, (BV, T, 3, H, W), generator=g,
                           dtype=torch.uint8).cuda()
    x = torch.rand(BV, T, 3, S, S, generator=g).cuda()
    log(f"training-shape views: fscal {s['fscal'].cpu().tolist()}")
    for name, kern, plain, args, crop, dtype, in_bytes in (
            ("crop_photometric", crop_photometric, crop_photometric_reference,
             (videos, s["rh"], s["rw"]), (s["rh"], s["rw"]), torch.bfloat16,
             videos.numel()),
            ("photometric", photometric, photometric_reference, (x,), (),
             torch.float32, 4 * x.numel())):
        full = args + (s["fscal"], s["orders"], s["mh"], s["mw"])
        for dt in (torch.float32, torch.bfloat16):
            check(name, kern(*full, out_dtype=dt), plain(*full, out_dtype=dt), dt,
                  f"({BV}, {T}, 3, {args[0].shape[-2]}, {args[0].shape[-1]}) -> {S}")
        ms, plain_ms, _ = timed(lambda: kern(*full, out_dtype=dtype),
                                lambda: plain(*full, out_dtype=dtype))
        out_bytes = BV * T * 3 * S * S * (2 if dtype == torch.bfloat16 else 4)
        b_ms, b_by = bound(in_bytes + out_bytes,
                           photometric_flops(s["fscal"], T, S, *crop))
        entries[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None,
                             max_abs_err=max_err[name])
        log(f"time {name} ({BV}, {T}) -> {S} {str(dtype)[6:]} out: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"library none")
    return entries


def phase_vit_kernels():
    """The four ViT kernels against their plain versions in fp32 and bf16 at
    the MV-Former chunk and a ragged last chunk; then each timed in bf16 (the
    path's type under USE_AMP) at the chunk, beside its plain version, a
    library composition of the same function and its bound."""
    import torch.nn.functional as F

    from video_rep_learning_tpu_torch.ops import bounds
    from video_rep_learning_tpu_torch.ops.attention import (
        packed_attention_reference, packed_vit_attention)
    from video_rep_learning_tpu_torch.ops.layernorm import (fused_layernorm,
                                                            layernorm_reference)
    from video_rep_learning_tpu_torch.ops.matmul import (
        ln_matmul_bias_act, ln_matmul_bias_act_reference)
    from video_rep_learning_tpu_torch.ops.vit_block import (
        vit_attention_block, vit_attention_block_reference)

    g = torch.Generator().manual_seed(SEED + 3)

    def inputs(shape, dtype):
        n, N, D = shape
        r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        return dict(
            x=(r(n, N, D) * 2 + 0.5).to("cuda", dtype),
            qkv=r(n, N, 3 * D).to("cuda", dtype),
            ln_s=(1 + 0.1 * r(D)).cuda(), ln_b=(0.1 * r(D)).cuda(),
            w1=(r(4 * D, D) * D ** -0.5).to("cuda", dtype), b1=(0.1 * r(4 * D)).cuda(),
            wqkv=(r(3 * D, D) * D ** -0.5).to("cuda", dtype),
            bqkv=(0.1 * r(3 * D)).cuda(),
            wp=(r(D, D) * D ** -0.5).to("cuda", dtype), bp=(0.1 * r(D)).cuda())

    def cases(a, heads):
        """name -> [(what, kernel call, plain call)]."""
        return {
            "layernorm": [("", lambda: fused_layernorm(a["x"], a["ln_s"], a["ln_b"]),
                           lambda: layernorm_reference(a["x"], a["ln_s"], a["ln_b"]))],
            "ln_gemm": [(f"LN + fc1 + {act}",
                         lambda act=act: ln_matmul_bias_act(
                             a["x"], a["ln_s"], a["ln_b"], a["w1"], a["b1"], act),
                         lambda act=act: ln_matmul_bias_act_reference(
                             a["x"], a["ln_s"], a["ln_b"], a["w1"], a["b1"], act))
                        for act in ("none", "gelu_exact", "gelu_tanh")] + [
                ("proj + residual, no LN",
                 lambda: ln_matmul_bias_act(a["x"], None, None, a["wp"], a["bp"],
                                            residual=a["x"]),
                 lambda: ln_matmul_bias_act_reference(a["x"], None, None, a["wp"],
                                                      a["bp"], residual=a["x"]))],
            "packed_attn": [("", lambda: packed_vit_attention(a["qkv"], heads),
                             lambda: packed_attention_reference(a["qkv"], heads))],
            "vit_attention_block": [("", lambda: vit_attention_block(
                a["x"], a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wp"],
                a["bp"], heads), lambda: vit_attention_block_reference(
                a["x"], a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wp"],
                a["bp"], heads))],
        }

    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in VIT_SHAPES:
            a = inputs(shape, dtype)
            for name, runs in cases(a, shape[-1] // 64).items():
                for what, kern, plain in runs:
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = (VIT_FP32_TOL[name] if dtype == torch.float32 else
                           VIT_BF16_ULPS[name] * 2.0 ** -7
                           * max(1.0, want.float().abs().max().item()))
                    ok = (err <= tol and got.shape == want.shape
                          and got.dtype == want.dtype
                          and bool(torch.isfinite(got.float()).all()))
                    log(f"kernel vs plain {name} {str(dtype)[6:]:8s} {shape}"
                        f"{' ' + what if what else ''}: err {err:.3e} (tol "
                        f"{tol:.2e}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees at {shape} {dtype}")
                    if dtype == torch.float32 and shape == VIT_SHAPES[0]:
                        max_err[name] = max(max_err.get(name, 0.0), err)
            del a

    # times at the chunk in bf16; the library call is a yardstick only
    n, N, D = VIT_SHAPES[0]
    heads, rows = D // 64, n * N
    a = inputs(VIT_SHAPES[0], torch.bfloat16)
    lib = {k: a[k].bfloat16() for k in ("ln_s", "ln_b", "b1", "bqkv", "bp")}
    split = a["qkv"].view(n, N, 3, heads, 64).permute(2, 0, 3, 1, 4).contiguous()

    def library_block():
        h = F.layer_norm(a["x"], (D,), lib["ln_s"], lib["ln_b"], 1e-6)
        qkv = F.linear(h, a["wqkv"], lib["bqkv"]).view(n, N, 3, heads, 64)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, N, D)
        return a["x"] + F.linear(o, a["wp"], lib["bp"])

    timing = {
        "layernorm": (cases(a, heads)["layernorm"][0][1:],
                      lambda: F.layer_norm(a["x"], (D,), lib["ln_s"], lib["ln_b"], 1e-6),
                      "layer_norm", bounds.layernorm(rows, D, 2)),
        "ln_gemm": (cases(a, heads)["ln_gemm"][1][1:],
                    lambda: F.gelu(F.linear(F.layer_norm(
                        a["x"], (D,), lib["ln_s"], lib["ln_b"], 1e-6), a["w1"], lib["b1"])),
                    "layer_norm + linear + gelu, LN2 + fc1 + exact GELU",
                    bounds.ln_matmul(rows, D, 4 * D, 2, activation="gelu_exact")),
        "packed_attn": (cases(a, heads)["packed_attn"][0][1:],
                        lambda: F.scaled_dot_product_attention(*split),
                        "scaled_dot_product_attention on the split heads",
                        bounds.packed_attention(n, N, D, heads, 2)),
        "vit_attention_block": (cases(a, heads)["vit_attention_block"][0][1:],
                                library_block,
                                "layer_norm + linear + SDPA + linear + add",
                                bounds.vit_attention_block(n, N, D, heads, 2)),
    }
    entries = {}
    for name, ((kern, plain), library, lib_what, work) in timing.items():
        ms, plain_ms, lib_ms = timed(kern, plain, library)
        b_ms, b_by = bounds.bound(*work)
        entries[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, max_abs_err=max_err[name])
        log(f"time {name} {VIT_SHAPES[0]} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            f"({lib_what}) {lib_ms:.4f} ms")
    return entries


class EmbeddingCheck:
    """An extra embedding task for this run: checks what the main path
    produced (finite, unit norm, 128-d, one embedding per frame)."""

    seen = []

    def __init__(self, cfg):
        self.downstream_task = True

    def evaluate(self, dataset, cur_epoch, summary_writer):
        for split in ("train_dataset", "val_dataset"):
            d = dataset[split]
            frames = sum(e.shape[0] for e in d["embs"])
            if frames != sum(d["seq_lens"]):
                raise AssertionError(f"{split}: {frames} embeddings for "
                                     f"{sum(d['seq_lens'])} frames")
            embs = np.concatenate(d["embs"])
            if embs.shape[1] != 128 or not np.isfinite(embs).all():
                raise AssertionError(f"{split}: bad embeddings {embs.shape}")
            norm_err = float(np.abs(np.linalg.norm(embs, axis=1) - 1).max())
            if norm_err > 1e-4:
                raise AssertionError(f"{split}: |norm - 1| up to {norm_err}")
            EmbeddingCheck.seen.append((split, frames, norm_err))
        return 1.0


def smoke_opts(extra=()):
    return ["DATA.NUM_WORKERS", "4", "EVAL.TASKS",
            "[kendalls_tau,retrieval,embedding_check]", *extra]


def phase_main_path(data_root, card):
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import (TASK_REGISTRY,
                                                         get_embeddings_dataset)
    from video_rep_learning_tpu_torch.models import build_model, save_checkpoint
    from video_rep_learning_tpu_torch.ops.attention import flash_attention_fwd

    logdir = os.path.join(WORK, "logs")
    argv = ["--workdir", data_root, "--logdir", logdir, "--cfg_file", CFG_FILE,
            "--device", "cuda", "--opts", *smoke_opts()]
    cfg = cli.load_config(cli.parse_cli(argv)[0])
    torch.manual_seed(SEED)
    save_checkpoint(build_model(cfg), logdir, 0)
    log("CARL model (configs/scl_transformer_config.yml, full width, seeded "
        "weights) saved as checkpoint_epoch_00000.pth")
    log("eval tasks: kendalls_tau and retrieval (they need only scipy; the "
        "card's machine has no sklearn) + this script's embedding check")

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    flash_attention_fwd.launches = 0
    t0 = time.time()
    metrics = cli.main(argv)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = flash_attention_fwd.launches
    log(f"main path: metrics {json.dumps(metrics)}, {cold_s:.2f} s cold "
        f"(model build, checkpoint load, cuDNN warm-up, both splits, tasks)")
    log(f"main path: flash_attn_fwd launches {launches}")
    if launches <= 0:
        raise AssertionError("the eval path never launched flash_attn_fwd")
    if len(EmbeddingCheck.seen) != 2:
        raise AssertionError("the embedding check did not run")
    for split, frames, norm_err in EmbeddingCheck.seen:
        log(f"main path: {split} {frames} embeddings, finite, 128-d, "
            f"max |norm - 1| {norm_err:.2e}")
    for name, vals in metrics.items():
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"task {name} gave {vals}")

    # warm throughput of the embedding sweep, same model and loaders
    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    model = build_model(cfg, "cuda")
    cli.load_checkpoint(model, logdir)
    loader = cli.build_eval_loaders(cfg, "val")[0]
    get_embeddings_dataset(cfg, model, loader, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = get_embeddings_dataset(cfg, model, loader, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    frames = sum(out["seq_lens"])
    log(f"embedding sweep (val, warm, USE_AMP bf16 backbone, {frames} frames "
        f"of 256x256 uint8 -> 224 px): {frames / dt:.1f} frames/s in "
        f"{dt:.3f} s on {card}")
    return launches


def phase_card_vs_cpu(data_root, logdir, cfg_file=CFG_FILE, frames=96,
                      what="CARL"):
    """The first `frames` frames of one val video through the eval sweep in
    fp32 (USE_AMP off, TF32 off) on the card and on the CPU, from the same
    checkpoint."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation.embedding import \
        get_embeddings_dataset
    from video_rep_learning_tpu_torch.models import build_model, load_checkpoint

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", cfg_file, "--logdir", logdir, "--opts", "USE_AMP",
         "False"])[0])
    with open(os.path.join(data_root, "pouring", "val.pkl"), "rb") as f:
        entry = pickle.load(f)[0]
    video = np.load(os.path.join(data_root, "pouring", entry["video_file"]))[:frames]
    item = {"video": video, "seq_len": frames, "name": entry["name"],
            "labels": np.asarray(entry["frame_label"])[:frames],
            "chosen_steps": np.arange(frames),
            "dims": np.array(video.shape[1:3], np.float32)}
    embs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        load_checkpoint(model, logdir)
        embs[dev] = get_embeddings_dataset(cfg, model, [item], dev)["embs"][0]
    err = float(np.abs(embs["cuda"] - embs["cpu"]).max())
    ok = embs["cuda"].shape == (frames, 128) and err <= CARD_VS_CPU_TOL
    log(f"card vs CPU, {what}, one {frames}-frame video, fp32 (TF32 off): max "
        f"|emb diff| {err:.3e} (tol {CARD_VS_CPU_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"card and CPU embeddings disagree ({what})")


def _launch_counters():
    from video_rep_learning_tpu_torch.ops import (attention, layernorm, matmul,
                                                  photometric, vit_block)

    return {"flash_attn_fwd": attention.flash_attention_fwd,
            "flash_attn_bwd": attention.flash_attention_bwd,
            "crop_photometric": photometric.crop_photometric,
            "photometric": photometric.photometric,
            "layernorm": layernorm.fused_layernorm,
            "ln_gemm": matmul.ln_matmul_bias_act,
            "packed_attn": attention.packed_vit_attention,
            "vit_attention_block": vit_block.vit_attention_block}


def _reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


def phase_train_path(data_root, card):
    """`python -m video_rep_learning_tpu_torch.train` at full width: one epoch
    over the 6 train videos with a checkpoint, then `--continue_train` for a
    second epoch resumed from it."""
    from video_rep_learning_tpu_torch.models import build_model
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    logdir = os.path.join(WORK, "train_logs")

    def argv(epochs, *flags):
        return ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                CFG_FILE, "--device", "cuda", *flags, "--opts", *smoke_opts(
                    ["TRAIN.MAX_EPOCHS", str(epochs), "LOGGING.REPORT_INTERVAL",
                     "3", "RNG_SEED", str(SEED)])]

    _reset_launches()
    t0 = time.time()
    train_main(argv(1))
    torch.cuda.synchronize()
    log(f"train path: epoch 0 in {time.time() - t0:.2f} s cold (build, loaders, "
        f"6 steps, checkpoint, val loss, evaluation)")
    ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
    log(f"train path: checkpoints after the first run: {ckpts}")
    if ckpts != ["checkpoint_epoch_00000.pth"]:
        raise AssertionError(f"expected one epoch-0 checkpoint, found {ckpts}")
    t0 = time.time()
    # --tempcfg: the run directory's frozen config.yml says 1 epoch
    trainer = train_main(argv(2, "--continue_train", "--tempcfg"))
    torch.cuda.synchronize()
    launches = _read_launches()
    log(f"train path: resumed at epoch {trainer.start_epoch}, epoch 1 in "
        f"{time.time() - t0:.2f} s; launches on the path {json.dumps(launches)}")
    if trainer.start_epoch != 1:
        raise AssertionError("the second run did not resume from epoch 0")
    for name in ("crop_photometric", "flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"the training path never launched {name}")

    # the weights moved where they train and nowhere else
    torch.manual_seed(trainer.cfg.RNG_SEED)
    init = build_model(trainer.cfg, "cpu").state_dict()
    trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    moved = frozen_moved = 0
    for n, v in trainer.model.state_dict().items():
        same = torch.equal(v.cpu(), init[n])
        if n in trainable:
            moved += not same
        elif n.startswith("backbone.") or n.startswith("classifier."):
            frozen_moved += not same
    log(f"train path: {moved} of {len(trainable)} trainable tensors moved, "
        f"{frozen_moved} frozen trunk / classifier tensors moved")
    if moved != len(trainable) or frozen_moved:
        raise AssertionError("the wrong parameters moved")

    # warm steps on one loaded batch, the same step function as the loop
    batch = next(iter(trainer.train_loader))
    losses, n_steps = [], 5
    dev = trainer.device_batch(batch)
    trainer.train_step(batch, dev, 9, 0, 1e-4)
    torch.cuda.synchronize()
    t0 = time.time()
    for it in range(n_steps):
        dev = trainer.device_batch(batch)
        losses.append(trainer.train_step(batch, dev, 9, it + 1, 1e-4))
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / n_steps * 1e3
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    clips = batch["videos"].shape[0]
    log(f"train step (warm, USE_AMP bf16 backbone, {clips} clip x 2 views x "
        f"{trainer.cfg.TRAIN.NUM_FRAMES} frames of 256x256 uint8 -> 224 px, "
        f"H2D + augment + forward + backward + Adam): {step_ms:.1f} ms/step, "
        f"{clips / step_ms * 1e3:.2f} clips/s on {card}; losses {losses}")
    return trainer, batch, launches


def phase_profile(trainer, batch):
    """One warm step under torch.profiler (device busy share, time by
    kernel), and one with CUDA events at the boundaries of its parts."""
    from torch.profiler import ProfilerActivity, profile

    m = trainer.model
    dev = trainer.device_batch(batch)
    trainer.train_step(batch, dev, 9, 50, 1e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        dev = trainer.device_batch(batch)
        trainer.train_step(batch, dev, 9, 51, 1e-4)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # kernels and copies on the card (the CPU ops that launched them carry
    # the same time again)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    log(f"profile (one warm step): wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms = {busy / wall * 100:.1f}% (idle "
        f"{100 - busy / wall * 100:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    prof.export_chrome_trace(os.path.join(WORK, "train_step_trace.json"))

    # the parts of one step, CUDA events between them (the host enqueues
    # ahead, so each span is device time plus any wait for the host)
    cfg = trainer.cfg
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    m.train()
    torch.cuda.synchronize()
    t0 = time.time()
    marks[0].record()
    dev = trainer.device_batch(batch)
    marks[1].record()
    videos = trainer.augment(batch, dev, 0, 9, 52)
    marks[2].record()
    B, V, T = videos.shape[:3]
    frames = m._nchw(videos.reshape((B * V * T,) + videos.shape[3:]))
    feats = m._run_frozen(frames)
    marks[3].record()
    with m._autocast(frames.device):
        feats = m.res_finetune(feats)
    marks[4].record()
    embs = m.head_embs(feats.view((B * V, T) + feats.shape[1:]), None,
                       cfg.TRAIN.NUM_FRAMES,
                       video_masks=dev["video_masks"].reshape(B * V, 1, T),
                       project=True)
    from video_rep_learning_tpu_torch.algos import scl_sequence_loss

    loss = scl_sequence_loss(
        embs.reshape(B, V, T, -1), dev["seq_lens"], dev["chosen_steps"],
        dev["video_masks"], temperature=cfg.SCL.SOFTMAX_TEMPERATURE,
        label_varience=cfg.SCL.LABEL_VARIENCE,
        positive_type=cfg.SCL.POSITIVE_TYPE,
        negative_type=cfg.SCL.NEGATIVE_TYPE)["loss"]
    marks[5].record()
    trainer.optimizer.zero_grad()
    loss.backward()
    marks[6].record()
    trainer.optimizer.step(1e-4)
    marks[7].record()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    names = ["H2D", "augment", "frozen trunk", "layer4 forward",
             "head + loss", "backward (layer4, head)", "clip + Adam"]
    spans = [marks[i].elapsed_time(marks[i + 1]) for i in range(7)]
    log(f"step parts (CUDA events, wall {wall:.1f} ms): " + ", ".join(
        f"{n} {t:.2f} ms" for n, t in zip(names, spans)))


GRAD_GROUPS = (("layer4", ("res_finetune.",)),
               ("FC+BN", ("embed.fc_layers.",)),
               ("encoder", ("embed.video_emb.", "embed.video_encoder.")),
               ("embedding + projection", ("embed.embedding_layer.",
                                           "ssl_projection.")))


def differing_frames(shape, seed):
    """uint8 frames (..., H, W, 3) that differ in colour and contrast: a
    random base colour per frame plus noise of a random amplitude."""
    rng = np.random.default_rng(seed)
    lead = shape[:-3]
    base = rng.uniform(30, 225, lead + (1, 1, 3))
    amp = rng.uniform(5, 60, lead + (1, 1, 1))
    noise = rng.standard_normal(shape, dtype=np.float32)
    return np.clip(base + amp * noise, 0, 255).astype(np.uint8)


def phase_step_card_vs_cpu(data_root):
    """One fp32 training step (USE_AMP False, TF32 off) on the card and on
    the CPU, full width with 16 frames a view: the same initial weights, the
    same batch and the same augmentation values sampled once on the host.
    Without USE_AMP the crop is the plain matmul and the photometric-only
    kernel runs. Then layer4 alone in fp64 on both devices, from the CPU
    step's layer3 features and upstream gradient."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.algos import SCL
    from video_rep_learning_tpu_torch.data import construct_dataloader
    from video_rep_learning_tpu_torch.models import build_model, set_trainable
    from video_rep_learning_tpu_torch.ops.augment import (AugmentParams,
                                                          sample_ssl_batch,
                                                          ssl_batch_augment)

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", CFG_FILE, "--opts", "USE_AMP", "False", "TRAIN.NUM_FRAMES",
         "16", "DATA.NUM_WORKERS", "0", "MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE",
         "0.0"])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, "pouring")
    loader, _ = construct_dataloader(cfg, "train")
    batch = next(iter(loader))
    B, V, _, H, W, _ = batch["videos"].shape
    # the loader's masks, lengths and steps, with frames that differ in place
    # of the synthetic set's (mostly a flat background)
    videos = differing_frames(tuple(batch["videos"].shape), SEED)
    aug = AugmentParams(image_size=cfg.IMAGE_SIZE)
    sampled = sample_ssl_batch(torch.Generator().manual_seed(SEED), B, V, H, W,
                               batch["dims"], aug)
    sampled["fscal"][:, [0, 5]] = 1  # jitter and blur on: the whole chain runs
    out, cap = {}, {}

    def capture(mod, inp, feats):  # layer4's input and upstream gradient
        cap["x"] = inp[0].detach()
        feats.register_hook(lambda g: cap.__setitem__("g", g.detach()))

    _reset_launches()
    for dev in ("cuda", "cpu"):
        torch.manual_seed(SEED)
        model = build_model(cfg, dev)
        named = set_trainable(model, cfg.MODEL.TRAIN_BASE)
        model.train()
        hook = model.res_finetune.register_forward_hook(capture)
        tb = {"videos": torch.as_tensor(videos).to(dev)}
        for k in ("video_masks", "seq_lens", "chosen_steps"):
            tb[k] = torch.as_tensor(batch[k]).to(dev)
        tb["videos"] = ssl_batch_augment(tb["videos"], sampled, aug)
        loss = SCL(cfg).compute_loss(model, tb)["loss"]
        loss.backward()
        hook.remove()
        out[dev] = (tb["videos"].float().cpu(), loss.item(),
                    {n: p.grad.float().cpu() for n, p in named if p.grad is not None})
    launches = _read_launches()
    # layer4 in fp64 on both devices, from the CPU step's input and upstream
    # gradient (the same initial weights)
    g64 = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(SEED)
        layer4 = build_model(cfg, dev).res_finetune.double().train()
        layer4(cap["x"].to(dev, torch.float64)).backward(cap["g"].to(dev, torch.float64))
        g64[dev] = {"res_finetune." + n: p.grad.cpu() for n, p in layer4.named_parameters()}
    (fa, la, ga), (fb, lb, gb) = out["cuda"], out["cpu"]

    def rel(x, y):
        """|x - y| at its largest, relative to the largest |y| (at least 1)."""
        return (x.double() - y.double()).abs().max().item() / max(
            1.0, y.abs().max().item())

    f_err = (fa - fb).abs().max().item()
    l_err = abs(la - lb) / abs(lb)
    groups = {g: [n for n in gb if n.startswith(p)] for g, p in GRAD_GROUPS}
    if sorted(sum(groups.values(), [])) != sorted(gb) or set(ga) != set(gb):
        raise AssertionError("the gradient tensors do not match the groups")
    log(f"card vs CPU, one fp32 training step ({B} clip x {V} views x 16 "
        f"frames that differ, full width, TF32 off): frames err {f_err:.3e} "
        f"(tol {STEP_TOL['frames']:.0e}), loss {la:.6f} vs {lb:.6f} (rel "
        f"{l_err:.2e}, tol {STEP_TOL['loss']:.0e}), photometric launches "
        f"{launches['photometric']}; gradients, each tensor relative to its "
        f"largest value (at least 1):")
    ok = (f_err <= STEP_TOL["frames"] and l_err <= STEP_TOL["loss"]
          and launches["photometric"] > 0)
    for group, names in groups.items():
        err, worst = max((rel(ga[n], gb[n]), n) for n in names)
        if group != "layer4":
            ok &= err <= STEP_TOL["grads"]
        log(f"  {group} ({len(names)} tensors), fp32: worst {worst} err "
            f"{err:.2e} " + (f"(tol {STEP_TOL['grads']:.0e})" if group != "layer4"
                             else "(held in fp64 below)"))
    layer4 = groups["layer4"]
    e64, w64 = max((rel(g64["cuda"][n], g64["cpu"][n]), n) for n in layer4)
    ok &= e64 <= STEP_TOL["layer4_fp64"] and set(g64["cpu"]) == set(layer4)
    own = {dev: max(rel(g[n], g64["cpu"][n]) for n in layer4)
           for dev, g in (("card", ga), ("CPU", gb))}
    log(f"  layer4 in fp64 on the CPU step's input and upstream gradient: "
        f"card vs CPU worst {w64} err {e64:.2e} (tol "
        f"{STEP_TOL['layer4_fp64']:.0e}); fp32 layer4 gradients against "
        f"these fp64 ones: the CPU's {own['CPU']:.2e}, the card's "
        f"{own['card']:.2e}")
    log(f"card vs CPU training step {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's fp32 training step disagrees with the CPU's")
    return launches


VIT_KERNELS = ("layernorm", "ln_gemm", "packed_attn", "vit_attention_block")


def phase_mvf_path(data_root, card):
    """`python -m video_rep_learning_tpu_torch.evaluate`'s function on
    configs_mvf/pouring_mvf.yml: a fully frozen ViT-B/8 at 224 px in bf16,
    3 static LSTP tokens, a 3-layer encoder over 3 T tokens; seeded
    full-width weights saved as a checkpoint."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import (TASK_REGISTRY,
                                                         get_embeddings_dataset)
    from video_rep_learning_tpu_torch.models import build_model, save_checkpoint

    logdir = os.path.join(WORK, "mvf_logs")
    argv = ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
            MVF_CFG_FILE, "--device", "cuda", "--opts", *smoke_opts()]
    cfg = cli.load_config(cli.parse_cli(argv)[0])
    torch.manual_seed(SEED)
    save_checkpoint(build_model(cfg), logdir, 0)
    log("MV-Former model (configs_mvf/pouring_mvf.yml: ViT-B/8 224 px fully "
        "frozen, SMART_FEATS 11, 3 static tokens, one-hot pool, final 'one', "
        "USE_AMP; full width, seeded weights) saved as checkpoint_epoch_00000.pth")

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    EmbeddingCheck.seen = []
    _reset_launches()
    t0 = time.time()
    metrics = cli.main(argv)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = _read_launches()
    log(f"MV-Former path: metrics {json.dumps(metrics)}, {cold_s:.2f} s cold "
        f"(model build, checkpoint load, both splits, tasks); launches "
        f"{json.dumps(launches)}")
    for name in VIT_KERNELS + ("flash_attn_fwd",):
        if launches[name] <= 0:
            raise AssertionError(f"the MV-Former path never launched {name}")
    # per ViT chunk of 12 blocks: 1 final norm, 12 half-blocks, each with one
    # attention and two GEMMs, and 12 LN2 + fc1 GEMMs
    blocks = launches["vit_attention_block"]
    if (blocks != 12 * launches["layernorm"] or launches["packed_attn"] != blocks
            or launches["ln_gemm"] != 3 * blocks):
        raise AssertionError(f"launch counts do not follow the ViT's blocks: {launches}")
    if len(EmbeddingCheck.seen) != 2:
        raise AssertionError("the embedding check did not run")
    for split, frames, norm_err in EmbeddingCheck.seen:
        log(f"MV-Former path: {split} {frames} embeddings, finite, 128-d, "
            f"max |norm - 1| {norm_err:.2e}")
    for name, vals in metrics.items():
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"task {name} gave {vals}")

    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    model = build_model(cfg, "cuda")
    cli.load_checkpoint(model, logdir)
    loader = cli.build_eval_loaders(cfg, "val")[0]
    get_embeddings_dataset(cfg, model, loader, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = get_embeddings_dataset(cfg, model, loader, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    frames = sum(out["seq_lens"])
    log(f"MV-Former embedding sweep (val, warm, bf16 ViT-B/8, {frames} frames "
        f"of 256x256 uint8 -> 224 px): {frames / dt:.1f} frames/s in {dt:.3f} s "
        f"on {card}")
    phase_mvf_profile(cfg, model, next(iter(loader)))
    return launches, logdir


# kernel-name fragments of the port's ViT kernels (the wrappers' CUDA
# functions) in a profile
OWN_KERNELS = {"gemm_bf16_kernel": "ln_gemm (#6, #5's qkv and proj)",
               "packed_attn_kernel": "packed_attn (#4)",
               "layernorm_kernel": "layernorm (#8)",
               "flash_fwd_kernel": "flash_attn_fwd (encoder)"}


def phase_mvf_profile(cfg, model, item):
    """One warm video of the MV-Former sweep under torch.profiler: wall,
    device busy share, and device time by kernel, the port's own kernels
    against everything else (fc2 is the largest other product)."""
    from torch.profiler import ProfilerActivity, profile

    from video_rep_learning_tpu_torch.evaluation.embedding import \
        get_embeddings_dataset

    get_embeddings_dataset(cfg, model, [item], "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        get_embeddings_dataset(cfg, model, [item], "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    log(f"MV-Former profile (one warm {item['seq_len']}-frame video): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms = "
        f"{busy / wall * 100:.1f}% (idle {100 - busy / wall * 100:.1f}%)")
    own = {label: 0.0 for label in OWN_KERNELS.values()}
    for e in events:
        for frag, label in OWN_KERNELS.items():
            if frag in e.key:
                own[label] += e.self_device_time_total / 1e6
    rest = busy - sum(own.values())
    log("  device time by kind: " + ", ".join(
        f"{label} {t * 1e3:.1f} ms ({t / busy * 100:.1f}%)" for label, t in own.items())
        + f", everything else {rest * 1e3:.1f} ms ({rest / busy * 100:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


SOURCES = {  # name: (source under the port, the TPU kernel it replaces)
    "flash_attn_fwd": ("csrc/flash_attn_fwd.cu", "attention_pallas.py:79"),
    "flash_attn_bwd": ("csrc/flash_attn_bwd.cu", "attention_pallas.py:98"),
    "crop_photometric": ("csrc/photometric.cu", "photometric_pallas.py:218"),
    "photometric": ("csrc/photometric.cu", "photometric_pallas.py:208"),
    "layernorm": ("csrc/layernorm.cu", "layernorm_pallas.py:36"),
    "ln_gemm": ("csrc/ln_gemm.cu", "matmul_gelu_pallas.py:198"),
    "packed_attn": ("csrc/packed_attn.cu", "attention_pallas.py:485"),
    # three launches of csrc/ln_gemm.cu and csrc/packed_attn.cu
    "vit_attention_block": ("ops/vit_block.py", "vit_block_pallas.py:102"),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only "
                 "on the GPU")
    card = phase_environment()
    phase_build()
    data_root, lens = make_synthetic_set()
    fwd_err = phase_kernel_vs_plain(lens)
    entries = phase_attention_backward()
    entries["flash_attn_fwd"]["max_abs_err"] = fwd_err
    entries.update(phase_augment())
    entries.update(phase_vit_kernels())
    eval_launches = phase_main_path(data_root, card)
    phase_card_vs_cpu(data_root, os.path.join(WORK, "logs"))
    trainer, batch, train_launches = phase_train_path(data_root, card)
    phase_profile(trainer, batch)
    step_launches = phase_step_card_vs_cpu(data_root)
    mvf_launches, mvf_logdir = phase_mvf_path(data_root, card)
    phase_card_vs_cpu(data_root, mvf_logdir, MVF_CFG_FILE, MVF_CARD_VS_CPU,
                      "MV-Former")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        if name in VIT_KERNELS:
            path, launches = "MV-Former eval", mvf_launches[name]
        elif name == "photometric":
            path, launches = "fp32 training step", step_launches[name]
        else:
            path, launches = "training (2 epochs)", train_launches[name]
        e = entries[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"video_rep_learning_tpu_torch/{src}",
            "replaces": f"video_rep_learning_tpu/ops/{replaces}",
            "launches": launches, "path": path,
            "eval_launches": eval_launches if name == "flash_attn_fwd" else 0,
            "mvf_eval_launches": mvf_launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
