#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
drives the CARL embedding and training paths, the MV-Former embedding and
training paths, the supervised paths, late fusion over a ViT, the FineGym
harness, a mid-epoch resume, data parallelism (a world of 1 over NCCL,
two ranks sharing the card over gloo), the trainer's device prefetch and
the frame-packed and packed eval sweeps end to end at full model width,
and compares the card with the CPU on each.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc builds every `video_rep_learning_tpu_torch/csrc/*.cu`, one
   compiler per source, all at once; each kernel's registers, stack and
   spills as ptxas reports them (those of the tensor-core kernels of #1,
   #3, #9, #10, 13c-13e and 13f, of the cluster kernels of #12 and #11 and
   of the elementwise chain go into the `kernels` line), and the chain's
   loops in its SASS (`tools/sass_loops.py`: the instructions of a rep);
3. kernel vs plain, and times beside the plain version, the bound and the
   library call where there is one:
   - flash-attention forward and backward in fp32 and bf16 at the CARL
     shapes and the MV-Former encoder's (2, 8, 720, 32), a long key range,
     padded keys and a fully masked row, both bit for bit against a second
     launch, timed with their share of the bound and SDPA's time; #1 also
     unmasked at (1, 8, 12000, 32), fg99_mvf.yml's eval chunk (2000 frames x
     6 LSTP tokens), held and timed beside SDPA;
   - crop+photometric and photometric at the CARL training shape
     (2 views x 240 frames of 256x256 uint8 -> 224), every flag, blur sigma
     0.1 and 2.0, a padded canvas, fp32 and bf16 output, and bit for bit
     against a second launch; photometric also at S 9, 100, 222 (rows of
     36 and 888 bytes, off the bulk copy's 16) and 512 (strips in chunks),
     contrast at each of the four positions, bit for bit against a second
     launch; then one 1080 x 1920 clip through
     `ssl_batch_augment` under USE_AMP, which the crop kernel's plan
     refuses: its route counter must say split;
   - the ViT kernels (LayerNorm, LN + matmul + bias + activation with each
     activation and with the residual epilogue, packed attention in both
     softmax forms, the attention half-block, matmul + GELU, the LN-MLP
     half-block) in fp32 and bf16 at the MV-Former chunk (40 x 785 x 768)
     and a ragged last chunk (7 frames), the LN-MLP half-block also in bf16
     at the trainable tail's 480 frames; the block's three GEMMs and both
     attention forms timed with their TFLOP/s, bound share and library
     ratio; #1 and #3 at the CARL training shape and the MV-Former
     encoder's beside SDPA on the same masked function (its backward alone
     for #3);
4. eval path: `python -m video_rep_learning_tpu_torch.evaluate`'s function on
   a synthetic Pouring set with a full-width CARL model (seeded weights) and
   the default four tasks (kendalls_tau, retrieval, classification,
   event_completion); checks launches, finiteness, unit norm and frame
   counts; reports frames/s;
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
   launches and the embeddings; reports warm frames/s, and again with the
   MLP half-block on #9 (VRL_FUSED_MLP=1: exactly one `ln_mlp_block` launch
   a block and chunk, the embeddings checked likewise); then 16 frames of
   one video in fp32, card vs CPU;
8. the fused SCL kernels (#10, four passes) against their plain versions at
   N = 480, 8640 and 308 frames, single_noself and batch_noself, over the
   tiles `scl_tiles` flags (held against `work_pairs`), bit for bit on a
   second launch and when walking every tile; times and bounds of each
   pass, loss + gradient and peak memory beside the plain loss; the auto
   gate at N = 8640;
9. MV-Former training: `python -m video_rep_learning_tpu_torch.train`'s
   function on `configs_mvf/pouring_mvf.yml` at full width under
   VRL_FUSED_SCL=1 (warm-started from a seeded checkpoint), one epoch, then
   `--continue_train` for a second; checks which tensors moved (every
   `backbone.*` bit-identical), the kernels' launches; reports warm ms per
   step and clips/s, and profiles one warm step;
10. one step of k400_mvf.yml's model and loss (3 taps, batch_noself, 2 x 2
   x 80 frames) under VRL_FUSED_SCL=1 and 0: loss and head gradients agree;
11. card vs CPU: one fp32 MV-Former training step, 8 frames a view;
12. the partially frozen ViT (pouring_mvf.yml with MODEL.BASE_MODEL.LAYER 10
   and MODEL.REMAT True: blocks 10-11 and the final norm train on all 480
   frames of a step): training through the CLI warm-started from the
   seeded fully frozen checkpoint, two epochs with a resume under
   VRL_FUSED_MLP=1 (#9); which tensors moved (every `backbone.*`
   bit-identical); one warm step under each MLP route of the JAX gates
   (#9, the default #6, VRL_FUSED_LN_MM=0's #8 + #7) with its exact ViT
   launches and peak memory; warm ms per step, clips/s and a profiled step;
13. card vs CPU: one fp32 partial-ViT training step, 8 frames a view,
   under the default gates and under VRL_FUSED_MLP=1, every `res_finetune`
   gradient tensor held.
14. the micro-benchmarks of row 13 (`video_rep_learning_tpu_torch/tools/`,
   the counterparts of the TPU scripts `tools/bench_ln_matmul.py`,
   `bench_packed_attn.py`, `bench_attn_variants.py`, `bench_int8_pallas.py`,
   `bench_vpu_bf16.py`), each through its `run("cuda")` at the TPU script's
   shapes: #6 in both TPU schedules' rows beside #8 + #7, the packed-attention
   variants beside #4 at B = 40 and 160, the int8 and bf16 tensor-core GEMM,
   the elementwise chain in three modes (also on NaN, ±inf and values
   outside [0, 1]: NaN where the plain version has NaN, bit for bit
   elsewhere); every row held against its plain version (tolerances above
   `TOOLS`), timed beside its plain version, library call and bound. None of their four kernels launches on the model
   paths of phases 4-13, 15 and 16;
15. the supervised paths at full width over the synthetic set (`SUP_CFGS`):
   tcc_transformer_config (TCC regression_mse_var, l2 similarity, 2 clips x
   240 frames, the supervised augmentation, USE_AMP) through the training
   CLI for an epoch, then `--continue_train` for a second, each with its val
   epoch and evaluation, #1 and #3 launched exactly once an encoder layer a
   step, val batch and eval chunk (#3 a step), warm ms per step and clips/s,
   a profiled step; tcc_config (the conv embedder, train_all: 2 x 40 steps
   x 2 contexts through conv1-layer3 with grad) one warm step with its peak
   memory, then the evaluation CLI's NUM_CONTEXTS 2 sweep and the default
   four tasks, its warm frames/s, no attention launched; one warm step of
   tcn_config and of scl_config (#12 launches), one of
   classification_transformer_config and its val epoch (masked accuracy in
   [0, 1]); then one fp32 TCC step of tcc_transformer_config, 96 frames a
   clip with every supervised jitter on, card vs CPU (loss and head
   gradients on STEP_TOL, layer4 in fp64, as phase 6);
16. (a) late fusion over a ViT (`configs_mvf/ablate_dinoB8_*`, ViT-B/8 fully
   frozen in bf16, 2 views x 80 frames a step, the synthetic Pouring set in
   place of Penn Action): ablate_dinoB8_avg (late-spatial, taps 3,7,11 ->
   2304 channels) through the training CLI for an epoch with a mid-epoch
   checkpoint every 2 steps, then `--continue_train` for a second (#1 and
   #3 once an encoder layer for each step, val batch and eval chunk, #12 a
   step and val batch, the ViT by its blocks, only epoch checkpoints left,
   every `backbone.*` bit-identical); warm steps of ablate_dinoB8_cls and
   ablate_dinoB8_max with their exact launches (the ViT by its 40-frame
   chunks, #1 / #3 / #12); a late-cls checkpoint holding the ViT under
   `backbone.*`, reloaded strictly; the eval sweep of late-cls and
   late-spatial (warm frames/s); 16 frames of one video card vs CPU in
   fp32 for each; (b) FineGym: a synthetic gym99-format set (20 train + 6
   val videos of 60-150 frames at 256 px), fg99_mvf.yml for an epoch
   through the training CLI (its evaluation is the harness), then the
   harness through `evaluate_finegym`'s function at the config's probe
   settings (LR 50, 100 epochs, fractions 0.1 / 0.5 / 1.0): one pickle per
   video and split, 256-d finite embeddings, accuracies in [0, 100], the
   sweep's frames/s and the probe's seconds; (c) pouring_mvf.yml (fully
   frozen, VRL_FUSED_SCL=1) for an epoch of 6 steps with a mid checkpoint
   every 2, uninterrupted, and again stopped after the second mid save
   and resumed: every tensor and optimizer moment bit-identical.
17. data parallelism (`video_rep_learning_tpu_torch/parallel/`): (a)
   pouring_mvf.yml through the training CLI under VRL_FUSED_SCL=1 for an
   epoch without a process group, then as rank 0 of a world of 1 over NCCL
   (`--coordinator 127.0.0.1:<port> --num_processes 1 --process_id 0`: DDP,
   the synced BatchNorm): every kernel's launches equal, every tensor and
   optimizer moment bit-identical; warm steps of both in turns; (b) two
   ranks on the one card over gloo (NCCL takes one rank a card), this
   process rank 0 and a second one rank 1: warm steps of
   scl_transformer_config (CARL, USE_AMP, 1 clip x 2 views x 240 frames a
   rank) and of pouring_mvf (VRL_FUSED_SCL=1, local N 480) with exact
   per-rank launches of #1, #3, #12 and #4-#6, #8, #10, the ranks' trainable
   tensors and BN statistics bit-identical after every step; one fp32 step
   at two ranks on the card against the same step on the CPU (STEP_TOL);
   one tcc_transformer step at 1 clip a rank (the global pair list); (c)
   fg99_mvf's FineGym harness at two ranks (each video dumped once, one
   file list, one accuracy). Two ranks on one card show correctness and
   overhead, not scaling.
18. the trainer's device prefetch and the eval sweeps: (a)
   scl_transformer_config (CARL) and tcc_transformer_config each through
   two trainers from one seed, at DATA.DEVICE_PREFETCH 0 and 2, their epochs
   in turns (a warm one, a timed one, a profiled one: at least 6 warm steps
   a depth), #1 / #3 / #12 launched exactly at both depths, every tensor and
   optimizer moment bit-identical between the depths after the last epoch;
   ms per step, the busy share of the profiled epoch, the batch's H2D in the
   step at depth 0 and on the copy stream at depth 2 (GB/s); pouring_mvf's
   epochs at depth 2, 0, 2; (b) the CARL and pouring_mvf val sweeps under
   USE_AMP per-video, frame-packed (VRL_EVAL_FLAT=1) and packed
   (EVAL.PACK_VIDEOS 2 and 4), each against per-video within SWEEP_TOL,
   with exact #1 / #4 launches and frames/s; the same in fp32 on three cut
   videos with chunks and blocks that split them; #1 masked at a packed
   group's shape against its plain version; fg99_mvf's harness dump with
   EVAL.FLAT_EXTRACT on against off; (c) `tools/bench_eval.py`'s ragged run
   (65-310 frames, FRAMES_PER_BATCH 2000) in each mode for both families.
Phase 3 also holds #7 (matmul + GELU) and #9 (the LN-MLP half-block)
against their plain versions, times #9 at 480 frames too, and checks the
six ViT kernels' gradients (the kernel forward, the plain backward chunked
over frames) against autograd of the plain versions on the card.

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
from contextlib import contextmanager

import numpy as np
import torch

# device time of back-to-back launches (CUDA events after a sleep kernel that
# lets the host queue them all) beside the host's time to issue one call, and
# kernel / plain / library times in turns
from video_rep_learning_tpu_torch.tools.common import cuda_ms, timed

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
CFG_FILE = os.path.join(REPO, "configs", "scl_transformer_config.yml")
MVF_CFG_FILE = os.path.join(REPO, "configs_mvf", "pouring_mvf.yml")
SEED = 0
# the CARL eval path gives the encoder (1, 8, n, 32) fp32 with n <= 1000
CARL_TIMING_SHAPES = [(1, 8, 240, 32), (1, 8, 1000, 32)]
# and the training path (2 views, 8 heads, 240 frames, 32) fp32
TRAIN_ATTN_SHAPE = (2, 8, 240, 32)
# the MV-Former encoder's attention: hidden 256 in 8 heads over 3 LSTP tokens
# x 240 frames, fp32 (models/mvformer.py); #1 and #3 are timed at both
MVF_ATTN_SHAPE = (2, 8, 720, 32)
TIMED_ATTN_SHAPES = (TRAIN_ATTN_SHAPE, MVF_ATTN_SHAPE)
# fg99_mvf.yml's eval chunk (EVAL.FRAMES_PER_BATCH 2000 x 6 LSTP tokens): the
# longest sequence any path gives #1, unmasked; held and timed in phase 3
FG_ATTN_SHAPE = (1, 8, 12000, 32)
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
# encoder, embedding, projection; MV-Former's LSTP too) relative to its own
# largest value, at least 1% of the step's largest head gradient (a tensor
# whose gradient is 0 in exact arithmetic holds rounding noise only), 2e-3:
# the same fp32 math summed in another order. fp32 does not
# determine layer4's gradients that far at the seeded random weights: the
# CPU's own fp32 layer4 gradients lie up to ~1e-1 of their largest value
# from its fp64 ones on the same inputs (printed every run, with the card's).
# So layer4 is held in fp64: its forward and backward on the CPU step's
# layer3 features and upstream gradient, card vs CPU, to 1e-8 of each
# tensor's largest value, on the same floor (fp64 rounding, 2^-53, times the
# ~1e6 by which fp32 shows these sums amplify rounding: ~1e-10)
STEP_TOL = {"frames": 1e-4, "loss": 1e-4, "grads": 2e-3, "layer4_fp64": 1e-8}
# the ViT kernels, max |kernel - plain| on the same inputs. fp32: the same
# fp32 math summed in another order (up to 768 products a sum, values of
# order 1-10). bf16: both sides round the same fp32 values at the same
# points, so an output may sit one ulp apart (2^-7 of the largest value);
# attention rounds p unnormalised in the kernel, normalised in the plain
# version (two ulps); the half-block composes three rounded stages, the
# last one (proj + residual) rounding once from fp32 (two)
VIT_FP32_TOL = {"layernorm": 1e-5, "ln_gemm": 1e-4, "packed_attn": 1e-5,
                "vit_attention_block": 1e-4, "matmul_bias_gelu": 1e-4,
                "ln_mlp_block": 1e-4}
# #9 rounds its activation before fc2 on both sides; one ulp apart there
# moves fc2's sum by far less than an output ulp, which then rounds once
# more: two ulps
VIT_BF16_ULPS = {"layernorm": 1, "ln_gemm": 1, "packed_attn": 2,
                 "vit_attention_block": 2, "matmul_bias_gelu": 1, "ln_mlp_block": 2}
# the ViT kernels' gradients (the kernel forward, the plain backward chunked
# over frames) against autograd of the plain version over all frames, each
# tensor relative to its largest value: fp32 the same math summed in
# another order; bf16: the chunked weight gradients round to bf16 once a
# chunk, the whole one once, and cuBLAS may sum a chunk's bf16 products in
# another order than the whole's: two bf16 ulps (2^-6)
VIT_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
VIT_GRAD_FRAMES, VIT_GRAD_CHUNK = 3, 2
VIT_SHAPES = [(40, 785, 768), (7, 785, 768)]  # a chunk, a ragged last chunk
MVF_CARD_VS_CPU = 16  # frames; fp32, TF32 off, 12 blocks: tol CARD_VS_CPU_TOL
K400_MVF_CFG_FILE = os.path.join(REPO, "configs_mvf", "k400_mvf.yml")
# the fused SCL kernels against their plain versions, fp32 on both sides
# (TF32 off): the same per-pair math summed in another order over up to
# 8640 x 8640 pairs. Each pass's per-row output (negsum and possum each a
# column of its own), max |kernel - plain| relative to its largest value:
# 1e-5 (row sums of exp(l) <= e^10 a pair in fp32, ~1e-6 of rounding). The loss through `scl_loss_fused` against
# `scl_sequence_loss`, relative: 1e-5. The gradient relative to its largest
# value: 1e-4, as the JAX package holds its fused backward against XLA
SCL_TOL = {"rows": 1e-5, "loss": 1e-5, "grad": 1e-4}
# (B, T) of two views: the pouring_mvf step, the auto gate's K400-scale
# batch (18 x 2 x 240), and a size no multiple of the 64-row tile
SCL_SHAPES = [(1, 240), (18, 240), (2, 77)]
SCL_NEGATIVES = ("single_noself", "batch_noself")
# fused vs plain SCL inside one MV-Former step, same weights, batch and
# dropout: the loss relative 1e-5 (the SCL kernels' own tolerance); each
# head gradient tensor relative to its largest value, on STEP_TOL's floor,
# 1e-4: the fused gradient's tolerance, carried linearly through the head's
# backward
FUSED_STEP_TOL = {"loss": 1e-5, "grads": 1e-4}
MVF_STEP_FRAMES = 8  # a view, for the card vs CPU fp32 MV-Former step
MVF_GRAD_GROUPS = (("LSTP", ("embed.pooling.",)),
                   ("FC+BN", ("embed.fc_layers.",)),
                   ("encoder", ("embed.video_emb.", "embed.video_encoder.")),
                   ("embedding + projection", ("embed.embedding_layer.",
                                               "ssl_projection.")))


def log(msg):
    print(msg, flush=True)


@contextmanager
def env_vars(**values):
    """Set environment variables (the JAX package's VRL_* gates) for the
    block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    logs = {}
    for name, so in libs.items():
        log_path = so.with_name(so.name + ".log")
        if log_path.exists():
            logs[name] = log_path.read_text()
            for line in logs[name].splitlines():
                if ("Compiling entry function" in line or "registers" in line
                        or "spill" in line):
                    log(f"  ptxas {name}: " + line.strip())
    built = {entry: ptxas_report(logs.get(src, ""), kernel)
             for entry, (src, kernel) in PTXAS_KERNELS.items()}
    missing = [PTXAS_KERNELS[e][1] for e, found in built.items() if not found]
    if missing:
        raise AssertionError(f"ptxas reported no {missing}")
    return built, chain_sass(libs["elementwise_chain"])


def chain_sass(lib):
    """The longest loop (the reps loop) of each `chain_kernel<MODE>` in the
    library's SASS, its instructions by opcode (`tools/sass_loops.py`)."""
    from video_rep_learning_tpu_torch.tools import sass_loops

    try:
        found = sass_loops.report(lib)
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        log(f"SASS of chain_kernel not read ({e}): not measured")
        return None
    out = {}
    for name, lps in found.items():
        if not lps:
            continue
        mode = name.split("chain_kernelILi")[1].split("E")[0]
        lp = max(lps, key=lambda x: x["instructions"])
        out[f"chain_kernel<{mode}>"] = lp
        log(f"SASS chain_kernel<{mode}>: reps loop {lp['start']}-{lp['end']}, "
            f"{lp['instructions']} instructions {lp['opcodes']}; every loop: "
            + "; ".join(f"{x['instructions']} ({x['start']}-{x['end']})" for x in lps))
    return out


# the `kernels` line's entries that carry their kernel's ptxas report (the
# tensor-core kernels of #9, 13c-13e, 13f, #1, #3 and #10, the cluster
# kernels of #12 and #11, and 13g's chain): entry: (source under csrc/, kernel)
PTXAS_KERNELS = {"ln_mlp_block": ("mlp_block", "mlp_wgmma_kernel"),
                 "packed_attn_variant": ("packed_attn_variants", "attn_variant_wgmma_kernel"),
                 "int8_gemm": ("int8_gemm", "gemm_wgmma_kernel"),
                 "flash_attn_fwd": ("flash_attn_fwd", "flash_fwd_mma_kernel"),
                 "flash_attn_bwd": ("flash_attn_bwd", "flash_bwd_mma_kernel"),
                 "crop_photometric": ("photometric", "crop_strip_kernel"),
                 "photometric": ("photometric", "photometric_strip_kernel"),
                 "elementwise_chain": ("elementwise_chain", "chain_kernel"),
                 # one kernel, a template instance a pass (scl_pass_kernel<0..3>)
                 **{name: ("scl", "scl_pass_kernel") for name in
                    ("scl_rowsum", "scl_loss_rows", "scl_srow", "scl_grad")}}
# the mangled template arguments these kernels take, and how they print: an
# integer literal (Li32E: 32), fp32, bf16
_TEMPLATE_ARG = r"L[a-z]\d+E|f|13__nv_bfloat16"
_TYPE_NAMES = {"f": "float", "13__nv_bfloat16": "bf16"}


def ptxas_report(text, kernel):
    """`kernel` as built, one instance per template argument list (e.g.
    `flash_bwd_mma_kernel<32,float>`): registers, stack frame and spill bytes
    from the `-Xptxas -v` lines after its entry."""
    import re

    found = re.findall(
        rf"Compiling entry function '[^']*{kernel}I((?:{_TEMPLATE_ARG})+)E[^']*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
        r"spill loads.*?Used (\d+) registers", text, re.S)
    report = {}
    for args, stack, stores, loads, regs in found:
        names = [_TYPE_NAMES.get(a) or a[2:-1] for a in re.findall(_TEMPLATE_ARG, args)]
        report[f"{kernel}<{','.join(names)}>"] = dict(
            registers=int(regs), stack=int(stack), spill_stores=int(stores),
            spill_loads=int(loads))
    return report


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
    """Every case goes through the wrapper on CUDA tensors, twice (the
    second launch bit for bit), and through `attention_reference` in fp32
    on the same (bf16-rounded) values."""
    from video_rep_learning_tpu_torch.ops.attention import (
        attention_reference, flash_attention_fwd)

    g = torch.Generator().manual_seed(SEED)
    cases = [(1, 8, s, 32) for s in (37, 128, 240, 600, 1000)]
    cases += [(2, 8, 240, 32), (1, 8, 6000, 32), (2, 12, 785, 64), FG_ATTN_SHAPE]
    cases += sorted({(1, 8, n, 32) for n in main_lens})
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            B, H, S, d = shape
            q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
                       for _ in range(3))
            masked = (shape not in [(1, 8, n, 32) for n in main_lens]
                      and shape != FG_ATTN_SHAPE)
            mask = None
            if masked:  # padded tail keys, plus a fully masked batch row
                mask = (torch.rand(B, S, generator=g) > 0.1).float()
                mask[:, S - S // 8:] = 0
                if B > 1:
                    mask[1] = 0
                mask = mask.cuda()
            out, lse = flash_attention_fwd(q, k, v, mask, d ** -0.5)
            again = flash_attention_fwd(q, k, v, mask, d ** -0.5)
            torch.cuda.synchronize()
            r_out, r_lse = attention_reference(q.float(), k.float(), v.float(),
                                               mask, d ** -0.5)
            e_out = (out.float() - r_out).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
            ok = (e_out <= TOL[(dtype, "out")] and e_lse <= TOL[(dtype, "lse")]
                  and bool(torch.isfinite(out.float()).all()) and same)
            log(f"kernel vs plain {str(dtype)[6:]:8s} {shape} "
                f"{'masked' if masked else 'no mask'}: out err {e_out:.3e} "
                f"(tol {TOL[(dtype, 'out')]:.1e}), lse err {e_lse:.3e} "
                f"(tol {TOL[(dtype, 'lse')]:.1e}), a second launch "
                f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attn_fwd disagrees at {shape} {dtype}")
            if dtype == torch.float32 and not masked:
                main_err = max(main_err, e_out)

    fg = time_flash_fwd(FG_ATTN_SHAPE, g)
    for shape in CARL_TIMING_SHAPES:
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        scale = shape[-1] ** -0.5
        kern = lambda: flash_attention_fwd(q, k, v, None, scale)  # noqa: E731
        plain = lambda: attention_reference(q, k, v, None, scale)  # noqa: E731
        # alternate plain, kernel, kernel, plain: both see the same clocks
        p1, k1, k2, p2 = (cuda_ms(f, reps=50)[0] for f in (plain, kern, kern, plain))
        log(f"time {shape} fp32 no mask: flash_attn_fwd kernel "
            f"{(k1 + k2) / 2:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
            f"attention_reference {(p1 + p2) / 2:.4f} ms ({p1:.4f}, {p2:.4f})")
    return main_err, fg


def time_flash_fwd(shape, g):
    """#1 at `shape` fp32 without a mask (the eval sweep's form): kernel,
    plain version, bound and SDPA."""
    import torch.nn.functional as F

    from video_rep_learning_tpu_torch.ops.attention import (attention_reference,
                                                            flash_attention_fwd)
    from video_rep_learning_tpu_torch.ops.bounds import attention_fwd, bound

    B, H, S, d = shape
    q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
    scale = d ** -0.5
    ms, plain_ms, lib_ms, host_ms = timed(
        lambda: flash_attention_fwd(q, k, v, None, scale),
        lambda: attention_reference(q, k, v, None, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=5)
    b_ms, b_by = bound(*attention_fwd(B, H, S, d))
    log(f"time {shape} fp32 no mask: flash_attn_fwd kernel {ms:.4f} ms (host "
        f"{host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; the kernel at {b_ms / ms * 100:.1f}% of it), library "
        f"(scaled_dot_product_attention, no mask) {lib_ms:.4f} ms, kernel / library "
        f"{ms / lib_ms:.2f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, host_ms=host_ms)


def phase_attention_backward():
    """flash_attn_bwd against `attention_backward_reference` on the same
    forward outputs (and bit for bit against a second launch), then the times
    of both directions at the CARL training and MV-Former encoder shapes."""
    from video_rep_learning_tpu_torch.ops.attention import (
        attention_backward_reference, flash_attention_bwd, flash_attention_fwd)

    g = torch.Generator().manual_seed(SEED + 1)
    cases = [TRAIN_ATTN_SHAPE, MVF_ATTN_SHAPE, (1, 8, 1000, 32), (1, 8, 6000, 32),
             (2, 4, 200, 64)]
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
            again = flash_attention_bwd(q, k, v, mask, out, lse, dout, d ** -0.5)
            torch.cuda.synchronize()
            want = attention_backward_reference(q, k, v, mask, out, lse, dout,
                                                d ** -0.5)
            errs = [(a.float() - b.float()).abs().max().item()
                    / max(1.0, b.float().abs().max().item())
                    for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = max(errs) <= BWD_TOL[dtype] and same and all(
                bool(torch.isfinite(a.float()).all()) for a in got)
            log(f"kernel vs plain flash_attn_bwd {str(dtype)[6:]:8s} {shape} "
                f"masked: dq/dk/dv err {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
                f"(tol {BWD_TOL[dtype]:.1e} of max|g|), a second launch "
                f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attn_bwd disagrees at {shape} {dtype}")
            if dtype == torch.float32 and shape == TRAIN_ATTN_SHAPE:
                main_err = max(errs)

    # the CARL training shape, then the MV-Former encoder's (3 LSTP tokens x
    # 240 frames): each direction beside its plain version, the bound and SDPA
    entries = {}
    for shape in TIMED_ATTN_SHAPES:
        for name, e in time_attention(shape, g).items():
            if shape == TRAIN_ATTN_SHAPE:
                entries[name] = e
            else:
                entries[name]["at_" + "x".join(map(str, shape))] = e
    entries["flash_attn_bwd"]["max_abs_err"] = main_err
    return entries


def time_attention(shape, g):
    """#1 and #3 at `shape` fp32, the last eighth of the keys masked: kernel,
    plain version, bound and SDPA given the same key mask as a boolean
    attn_mask (for #3 its backward alone, the forward untimed); #1 also
    without a mask, beside SDPA without one."""
    import torch.nn.functional as F

    from video_rep_learning_tpu_torch.ops.attention import (
        attention_backward_reference, attention_reference, flash_attention_bwd,
        flash_attention_fwd)
    from video_rep_learning_tpu_torch.ops.bounds import (attention_bwd,
                                                         attention_fwd, bound)

    B, H, S, d = shape
    q, k, v, dout = (torch.randn(shape, generator=g).cuda() for _ in range(4))
    mask = torch.ones(B, S, device="cuda")
    mask[:, S - S // 8:] = 0
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, mask, scale)
    # True where a key is attended, (B, 1, 1, S)
    sdpa_mask = mask.bool()[:, None, None, :]
    entries = {}
    ms, plain_ms, lib_ms, host_ms = timed(
        lambda: flash_attention_fwd(q, k, v, mask, scale),
        lambda: attention_reference(q, k, v, mask, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask, scale=scale))
    keys = int(mask.sum())  # the masked keys need no work
    b_ms, b_by = bound(*attention_fwd(B, H, S, d, keys=keys))
    entries["flash_attn_fwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms,
                                     host_ms=host_ms)
    # #1 again without a mask, beside SDPA without one
    ms, plain_ms, lib_ms, host_ms = timed(
        lambda: flash_attention_fwd(q, k, v, None, scale),
        lambda: attention_reference(q, k, v, None, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    b_ms, b_by = bound(*attention_fwd(B, H, S, d))
    entries["flash_attn_fwd"]["no_mask"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        host_ms=host_ms)
    log(f"time {shape} fp32 no mask: flash_attn_fwd kernel {ms:.4f} ms (host "
        f"{host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; the kernel at {b_ms / ms * 100:.1f}% of it), library "
        f"(scaled_dot_product_attention, no mask) {lib_ms:.4f} ms, kernel / library "
        f"{ms / lib_ms:.2f}")
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask, scale=scale)

    def sdpa_bwd():
        torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)

    ms, plain_ms, lib_ms, host_ms = timed(
        lambda: flash_attention_bwd(q, k, v, mask, out, lse, dout, scale),
        lambda: attention_backward_reference(q, k, v, mask, out, lse, dout, scale),
        sdpa_bwd)
    b_ms, b_by = bound(*attention_bwd(B, H, S, d, keys=keys))
    entries["flash_attn_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms,
                                     host_ms=host_ms)
    for name, e in entries.items():
        log(f"time {shape} fp32 masked: {name} kernel {e['ms']:.4f} ms "
            f"(host {e['host_ms']:.4f} ms a call), "
            f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}; the kernel at {e['bound_ms'] / e['ms'] * 100:.1f}% of "
            f"it), library (scaled_dot_product_attention, the same "
            f"key mask{', its backward alone' if name.endswith('bwd') else ''}) "
            f"{e['library_ms']:.4f} ms, kernel / library "
            f"{e['ms'] / e['library_ms']:.2f}")
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
    training shape with sampled values, checked and timed; then a 1080 x
    1920 clip through `ssl_batch_augment`'s split route."""
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

    tail_cases = photometric_cases(g, check)

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
            got = kern(*full, out_dtype=dt)
            check(name, got, plain(*full, out_dtype=dt), dt,
                  f"({BV}, {T}, 3, {args[0].shape[-2]}, {args[0].shape[-1]}) -> {S}")
            if not torch.equal(got, kern(*full, out_dtype=dt)):
                raise AssertionError(f"{name} differs between two launches ({dt})")
        log(f"{name}: a second launch bit-identical in fp32 and bf16")
        ms, plain_ms, _, host_ms = timed(lambda: kern(*full, out_dtype=dtype),
                                lambda: plain(*full, out_dtype=dtype))
        out_bytes = BV * T * 3 * S * S * (2 if dtype == torch.bfloat16 else 4)
        b_ms, b_by = bound(in_bytes + out_bytes,
                           photometric_flops(s["fscal"], T, S, *crop))
        entries[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None, host_ms=host_ms,
                             max_abs_err=max_err[name])
        log(f"time {name} ({BV}, {T}) -> {S} {str(dtype)[6:]} out: kernel "
            f"{ms:.4f} ms (host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), library none")
    # #11's time by what its views switch on, on the same frames (gray and
    # flip off): the staging, normalisation and 16-byte stores alone; with
    # the jitter ops and the cluster's mean; with the blur and its halo read
    # from the neighbours; with both
    parts = {}
    for what, jit, blur in (("stage+store", 0, 0), ("jitter", 1, 0), ("blur", 0, 1),
                            ("jitter+blur", 1, 1)):
        f = s["fscal"].clone()
        f[:, 0], f[:, 5], f[:, 6], f[:, 7] = jit, blur, 0, 0
        parts[what] = cuda_ms(lambda: photometric(x, f, s["orders"], s["mh"], s["mw"]))[0]
    entries["photometric"]["parts"] = parts
    log("time photometric by the views' flags (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    entries["photometric"]["at_1080p_split_route"] = augment_1080p(g, S)
    entries["photometric"]["tail_cases"] = tail_cases
    return entries


# photometric's frame sizes beyond the training shape: rows of 36 bytes and
# a strip of one row (9), 7-row strips (100), rows of 888 bytes (222; both
# off the bulk copy's 16-byte rows), strips in chunks with the mean in a
# sweep of its own (512)
TAIL_SIZES = (9, 100, 222, 512)


def photometric_cases(g, check, T=2):
    """photometric at TAIL_SIZES: four views with jitter on, contrast at
    position 0, 1, 2 and 3 of their op orders, blur on two (sigma 0.1 and
    2.0), gray on one, flip on two; fp32 and bf16 output against the plain
    version, and a second launch bit for bit."""
    from video_rep_learning_tpu_torch.ops.augment import ssl_matrices
    from video_rep_learning_tpu_torch.ops.photometric import (photometric,
                                                              photometric_reference)

    BV = 4
    fscal = torch.zeros(BV, 8)
    fscal[:, 0] = 1
    fscal[:, 1:4] = torch.rand(BV, 3, generator=g) + 0.5
    fscal[:, 4] = torch.rand(BV, generator=g) * 0.4 - 0.2
    fscal[:, 5] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    fscal[1, 6] = 1
    fscal[2:, 7] = 1
    orders = torch.tensor([[1, 0, 2, 3], [0, 1, 2, 3], [2, 3, 1, 0], [3, 0, 2, 1]],
                          dtype=torch.int32)
    done = []
    for S in TAIL_SIZES:
        m = ssl_matrices(torch.tensor([(0.0, 0.0, S, S)] * BV),
                         torch.tensor([0.1, 2.0, 0.1, 2.0]), S, S, S)
        x = torch.rand(BV, T, 3, S, S, generator=g)
        args = tuple(t.cuda() for t in (x, fscal, orders, m["mh"], m["mw"]))
        for dtype in (torch.float32, torch.bfloat16):
            got = photometric(*args, out_dtype=dtype)
            check("photometric", got, photometric_reference(*args, out_dtype=dtype), dtype,
                  f"S {S}, contrast at each position")
            if not torch.equal(got, photometric(*args, out_dtype=dtype)):
                raise AssertionError(f"photometric differs between two launches (S {S})")
        done.append(S)
    log(f"photometric at S {done}: a second launch bit-identical in fp32 and bf16")
    return done


def augment_1080p(g, S, T=240):
    """One 1080 x 1920 clip (2 views x T frames) through `ssl_batch_augment`
    under USE_AMP, as the trainer calls it: the crop kernel's plan refuses
    the canvas, so the route counter must say "split" (the resample in
    chunks of frames, then #11); the frames against the plain pipeline on
    the same sampled values at AUG_TOL, its peak memory and time."""
    from video_rep_learning_tpu_torch.ops import augment as aug
    from video_rep_learning_tpu_torch.ops.photometric import (
        crop_photometric, crop_photometric_reference, photometric)

    H, W, B, V = 1080, 1920, 1, 2
    p = aug.AugmentParams(image_size=S, use_amp=True)
    sampled = aug.sample_ssl_batch(g, B, V, H, W, None, p)
    sampled["fscal"][:, 0] = 1  # jitter on: the contrast mean runs
    videos = torch.randint(0, 256, (B, V, T, H, W, 3), generator=g,
                           dtype=torch.uint8).cuda()
    counts = lambda: (aug.ssl_batch_augment.crop_route,  # noqa: E731
                      aug.ssl_batch_augment.split_route, crop_photometric.launches,
                      photometric.launches)
    with env_vars(VRL_FUSED_CROP="auto"):
        before = counts()
        peak = _peak_mib(lambda: aug.ssl_batch_augment(videos, sampled, p))
        taken = tuple(a - b for a, b in zip(counts(), before))
        out = aug.ssl_batch_augment(videos, sampled, p)
        ms, host_ms = cuda_ms(lambda: aug.ssl_batch_augment(videos, sampled, p), reps=3,
                              warmup=1)
    m = {k: t.cuda() for k, t in sampled.items()}
    # #11's share of the route: the photometric launch alone on the resample
    cropped = aug._split_crop(videos, m["rh"], m["rw"])
    tail_ms = cuda_ms(lambda: photometric(cropped, m["fscal"], m["orders"], m["mh"], m["mw"],
                                          torch.bfloat16), reps=10, warmup=2)[0]
    del cropped
    planar = videos.reshape(B * V, T, H, W, 3).permute(0, 1, 4, 2, 3).contiguous()
    want = crop_photometric_reference(planar, m["rh"], m["rw"], m["fscal"], m["orders"],
                                      m["mh"], m["mw"], torch.bfloat16)
    err = (out.float() - want.view(B, V, T, 3, S, S).permute(0, 1, 2, 4, 5, 3).float()
           ).abs().max().item()
    whole = B * V * T * 3 * H * W * 4 / 2 ** 20
    ok = (taken == (0, 1, 0, 1) and err <= AUG_TOL[torch.bfloat16]
          and out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all()))
    log(f"ssl_batch_augment under USE_AMP, {B * V} x {T} frames of {H} x {W} -> {S}: "
        f"routes crop/split/#12/#11 {taken} (split expected), err {err:.3e} against the "
        f"plain pipeline (tol {AUG_TOL[torch.bfloat16]:.1e}), peak {peak:.1f} MiB above "
        f"the canvas (the fp32 canvas in one piece {whole:.1f} MiB), {ms:.3f} ms, of which "
        f"#11 {tail_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the split route of a 1080 x 1920 canvas failed")
    del videos, planar, want, out
    torch.cuda.empty_cache()
    return dict(ms=ms, host_ms=host_ms, max_abs_err=err, peak_mib=peak, photometric_ms=tail_ms)


def phase_vit_kernels():
    """The six ViT kernels (#8, #6, #4, #5, #7, #9) against their plain
    versions in fp32 and bf16 at the MV-Former chunk and a ragged last chunk,
    with each activation; then each timed in bf16 (the path's type under
    USE_AMP) at the chunk, beside its plain version, a library composition
    of the same function and its bound; the three GEMMs of a block (qkv,
    proj, fc1) and #4 in both softmax forms with their rates, bound shares
    and library ratios; and #9 again at the trainable tail's 480 frames."""
    import torch.nn.functional as F

    from video_rep_learning_tpu_torch.ops import bounds
    from video_rep_learning_tpu_torch.ops.attention import (
        packed_attention_reference, packed_vit_attention)
    from video_rep_learning_tpu_torch.ops.layernorm import (fused_layernorm,
                                                            layernorm_reference)
    from video_rep_learning_tpu_torch.ops.matmul import (
        ln_matmul_bias_act, ln_matmul_bias_act_reference, ln_mlp_block,
        ln_mlp_block_reference, matmul_bias_gelu, matmul_bias_gelu_reference)
    from video_rep_learning_tpu_torch.ops.vit_block import (
        vit_attention_block, vit_attention_block_reference)

    g = torch.Generator().manual_seed(SEED + 3)

    def with_env(fn, **values):
        def call():
            with env_vars(**values):
                return fn()
        return call

    def inputs(shape, dtype):
        n, N, D = shape
        r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        return dict(
            x=(r(n, N, D) * 2 + 0.5).to("cuda", dtype),
            qkv=r(n, N, 3 * D).to("cuda", dtype),
            ln_s=(1 + 0.1 * r(D)).cuda(), ln_b=(0.1 * r(D)).cuda(),
            w1=(r(4 * D, D) * D ** -0.5).to("cuda", dtype), b1=(0.1 * r(4 * D)).cuda(),
            w2=(r(D, 4 * D) * (4 * D) ** -0.5).to("cuda", dtype), b2=(0.1 * r(D)).cuda(),
            wqkv=(r(3 * D, D) * D ** -0.5).to("cuda", dtype),
            bqkv=(0.1 * r(3 * D)).cuda(),
            wp=(r(D, D) * D ** -0.5).to("cuda", dtype), bp=(0.1 * r(D)).cuda())

    def mlp_args(a):
        return a["x"], a["ln_s"], a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"]

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
                             lambda: packed_attention_reference(a["qkv"], heads)),
                            ("VRL_ATTN_MAXSUB=1",
                             with_env(lambda: packed_vit_attention(a["qkv"], heads),
                                      VRL_ATTN_MAXSUB="1"),
                             lambda: packed_attention_reference(a["qkv"], heads))],
            "vit_attention_block": [("", lambda: vit_attention_block(
                a["x"], a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wp"],
                a["bp"], heads), lambda: vit_attention_block_reference(
                a["x"], a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wp"],
                a["bp"], heads))],
            "matmul_bias_gelu": [(f"fc1 + {act}",
                                  lambda approx=approx: matmul_bias_gelu(
                                      a["x"], a["w1"], a["b1"], approx),
                                  lambda approx=approx: matmul_bias_gelu_reference(
                                      a["x"], a["w1"], a["b1"], approx))
                                 for act, approx in (("gelu_exact", False),
                                                     ("gelu_tanh", True))],
            "ln_mlp_block": [(f"LN2 + fc1 + {act} + fc2 + residual",
                              lambda act=act: ln_mlp_block(*mlp_args(a), act),
                              lambda act=act: ln_mlp_block_reference(*mlp_args(a), act))
                             for act in ("gelu_exact", "gelu_tanh")],
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
    lib = {k: a[k].bfloat16() for k in ("ln_s", "ln_b", "b1", "b2", "bqkv", "bp")}
    split = a["qkv"].view(n, N, 3, heads, 64).permute(2, 0, 3, 1, 4).contiguous()

    def library_block():
        h = F.layer_norm(a["x"], (D,), lib["ln_s"], lib["ln_b"], 1e-6)
        qkv = F.linear(h, a["wqkv"], lib["bqkv"]).view(n, N, 3, heads, 64)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, N, D)
        return a["x"] + F.linear(o, a["wp"], lib["bp"])

    def library_mlp(x):
        h = F.gelu(F.linear(F.layer_norm(x, (D,), lib["ln_s"], lib["ln_b"], 1e-6),
                            a["w1"], lib["b1"]))
        return x + F.linear(h, a["w2"], lib["b2"])

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
        "matmul_bias_gelu": (cases(a, heads)["matmul_bias_gelu"][0][1:],
                             lambda: F.gelu(F.linear(a["x"], a["w1"], lib["b1"])),
                             "linear + gelu, fc1 + exact GELU",
                             bounds.ln_matmul(rows, D, 4 * D, 2, ln=False,
                                              activation="gelu_exact")),
        "ln_mlp_block": (cases(a, heads)["ln_mlp_block"][0][1:],
                         lambda: library_mlp(a["x"]),
                         "layer_norm + linear + gelu + linear + add",
                         bounds.mlp_block(rows, D, 4 * D, 2)),
    }
    entries = {}
    for name, ((kern, plain), library, lib_what, work) in timing.items():
        ms, plain_ms, lib_ms, host_ms = timed(kern, plain, library)
        b_ms, b_by = bounds.bound(*work)
        entries[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, host_ms=host_ms,
                             max_abs_err=max_err[name])
        log(f"time {name} {VIT_SHAPES[0]} bf16: kernel {ms:.4f} ms (host "
            f"{host_ms:.4f} ms a call), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            f"({lib_what}) {lib_ms:.4f} ms")

    # the three GEMMs of a block and attention in both softmax forms, each in
    # turns with its library call (kernel, library, library, kernel): rate,
    # share of the bound, ratio to the library
    o_in = packed_vit_attention(a["qkv"], heads)

    def lnx():
        return F.layer_norm(a["x"], (D,), lib["ln_s"], lib["ln_b"], 1e-6)

    def attn(maxsub):
        return with_env(lambda: packed_vit_attention(a["qkv"], heads),
                        VRL_ATTN_MAXSUB=maxsub)

    parts = {
        ("ln_gemm", "qkv: LN1 + 768 -> 2304"): (
            lambda: ln_matmul_bias_act(a["x"], a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"]),
            lambda: F.linear(lnx(), a["wqkv"], lib["bqkv"]),
            bounds.ln_matmul(rows, D, 3 * D, 2)),
        ("ln_gemm", "proj: 768 -> 768 + residual"): (
            lambda: ln_matmul_bias_act(o_in, None, None, a["wp"], a["bp"], residual=a["x"]),
            lambda: a["x"] + F.linear(o_in, a["wp"], lib["bp"]),
            bounds.ln_matmul(rows, D, D, 2, ln=False, residual=True)),
        ("ln_gemm", "fc1: LN2 + 768 -> 3072 + GELU"): (
            lambda: ln_matmul_bias_act(a["x"], a["ln_s"], a["ln_b"], a["w1"], a["b1"],
                                       "gelu_exact"),
            lambda: F.gelu(F.linear(lnx(), a["w1"], lib["b1"])),
            bounds.ln_matmul(rows, D, 4 * D, 2, activation="gelu_exact")),
        ("packed_attn", "max-free softmax"): (
            attn("0"), lambda: F.scaled_dot_product_attention(*split),
            bounds.packed_attention(n, N, D, heads, 2)),
        ("packed_attn", "VRL_ATTN_MAXSUB=1"): (
            attn("1"), lambda: F.scaled_dot_product_attention(*split),
            bounds.packed_attention(n, N, D, heads, 2)),
    }
    for (name, what), (kern, library, work) in parts.items():
        k1, l1, l2, k2 = (cuda_ms(f)[0] for f in (kern, library, library, kern))
        ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
        b_ms, b_by = bounds.bound(*work)
        tflops = work[1] / ms / 1e9
        entries[name].setdefault("parts", {})[what] = dict(
            ms=ms, tflops=tflops, bound_ms=b_ms, bound_share=b_ms / ms,
            library_ms=lib_ms)
        log(f"time {name} {what} {VIT_SHAPES[0]} bf16: kernel {ms:.4f} ms, "
            f"{tflops:.1f} TFLOP/s, {b_ms / ms * 100:.1f}% of the bound {b_ms:.4f} ms "
            f"({b_by}); library {lib_ms:.4f} ms, kernel / library {ms / lib_ms:.2f}")
    del o_in

    # #9 at the partially frozen ViT's trainable tail: every frame of a step
    # (1 clip x 2 views x 240) at once
    frames = 2 * 240
    gc = torch.Generator(device="cuda").manual_seed(SEED + 3)
    big = dict(a, x=(torch.randn(frames, N, D, generator=gc, device="cuda") * 2
                     + 0.5).bfloat16())
    # checked against plain at this M first: a block of the persistent
    # kernel walks ~45 panels here, against ~4 at the chunk
    got = ln_mlp_block(*mlp_args(big), "gelu_exact")
    torch.cuda.synchronize()
    want = ln_mlp_block_reference(*mlp_args(big), "gelu_exact")
    err = (got.float() - want.float()).abs().max().item()
    tol = (VIT_BF16_ULPS["ln_mlp_block"] * 2.0 ** -7
           * max(1.0, want.float().abs().max().item()))
    ok = (err <= tol and got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(got.float()).all()))
    log(f"kernel vs plain ln_mlp_block bfloat16 ({frames}, {N}, {D}) LN2 + fc1 + "
        f"gelu_exact + fc2 + residual: err {err:.3e} (tol {tol:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ln_mlp_block disagrees at ({frames}, {N}, {D}) bf16")
    del got, want
    ms, plain_ms, lib_ms, _ = timed(lambda: ln_mlp_block(*mlp_args(big)),
                                 lambda: ln_mlp_block_reference(*mlp_args(big)),
                                 lambda: library_mlp(big["x"]), reps=3)
    b_ms, b_by = bounds.bound(*bounds.mlp_block(frames * N, D, 4 * D, 2))
    entries["ln_mlp_block"].update(ms_480=ms, plain_ms_480=plain_ms,
                                   bound_ms_480=b_ms, library_ms_480=lib_ms,
                                   max_abs_err_480=err)
    log(f"time ln_mlp_block ({frames}, {N}, {D}) bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library {lib_ms:.4f} ms")
    return entries


def phase_vit_grads():
    """The six ViT kernels' wrappers differentiated on the card (the kernel
    forward, autograd of the plain version chunked over frames backward)
    against autograd of the plain version over all frames, at full width,
    VIT_GRAD_FRAMES frames in chunks of VIT_GRAD_CHUNK, fp32 and bf16: each
    input's gradient relative to its largest value; each forward launched
    its kernel."""
    from video_rep_learning_tpu_torch.ops import attention, layernorm, matmul, vit_block

    g = torch.Generator().manual_seed(SEED + 5)
    n, N, D = VIT_GRAD_FRAMES, 785, 768
    heads, ch = D // 64, VIT_GRAD_CHUNK
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        x = (r(n, N, D) * 2 + 0.5).to("cuda", dtype)
        vec = lambda k, s=0.1, m=0.0: (m + s * r(k)).cuda()  # noqa: E731
        mat = lambda o, i: (r(o, i) * i ** -0.5).to("cuda", dtype)  # noqa: E731
        ln = (vec(D, m=1.0), vec(D))
        cases = {  # name: (wrapper, plain, args, launch counter)
            "layernorm": (layernorm.fused_layernorm, layernorm.layernorm_reference,
                          (x, *ln), layernorm.fused_layernorm),
            "ln_gemm": (matmul.ln_matmul_bias_act, matmul.ln_matmul_bias_act_reference,
                        (x, *ln, mat(4 * D, D), vec(4 * D), "gelu_exact"),
                        matmul.ln_matmul_bias_act),
            "packed_attn": (attention.packed_vit_attention,
                            attention.packed_attention_reference,
                            (r(n, N, 3 * D).to("cuda", dtype), heads),
                            attention.packed_vit_attention),
            "vit_attention_block": (
                vit_block.vit_attention_block, vit_block.vit_attention_block_reference,
                (x, *ln, mat(3 * D, D), vec(3 * D), mat(D, D), vec(D), heads),
                vit_block.vit_attention_block),
            "matmul_bias_gelu": (matmul.matmul_bias_gelu,
                                 matmul.matmul_bias_gelu_reference,
                                 (x, mat(4 * D, D), vec(4 * D), False),
                                 matmul.matmul_bias_gelu),
            "ln_mlp_block": (matmul.ln_mlp_block, matmul.ln_mlp_block_reference,
                             (x, *ln, mat(4 * D, D), vec(4 * D), mat(D, 4 * D), vec(D),
                              "gelu_exact"), matmul.ln_mlp_block),
        }
        for name, (fn, plain, args, counter) in cases.items():
            grads = {}
            for how in ("kernel", "plain"):
                leaves = [a.detach().clone().requires_grad_()
                          if isinstance(a, torch.Tensor) else a for a in args]
                before = counter.launches
                y = (fn(*leaves, grad_chunk=ch) if how == "kernel" else plain(*leaves))
                launched = counter.launches - before
                ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
                (y.float() * ct.cuda()).sum().backward()
                torch.cuda.synchronize()
                grads[how] = [a.grad for a in leaves if isinstance(a, torch.Tensor)]
                if how == "kernel" and launched != 1:
                    raise AssertionError(f"{name}: the forward launched {launched} times")
            errs = [_rel(k.float(), p.float()) for k, p in zip(*grads.values())]
            ok = (max(errs) <= VIT_GRAD_TOL[dtype]
                  and all(k.dtype == p.dtype for k, p in zip(*grads.values())))
            log(f"gradient {name} {str(dtype)[6:]:8s} ({n}, {N}, {D}), chunks of {ch}: "
                f"worst input {max(errs):.2e} of its largest (tol "
                f"{VIT_GRAD_TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}'s gradient disagrees on the card")


class EmbeddingCheck:
    """An extra embedding task for this run: checks what the main path
    produced (finite, unit norm, 128-d, one embedding per frame)."""

    seen = []

    def __init__(self, cfg):
        self.downstream_task = True
        # TCC's configs leave the embeddings unnormalised (MODEL.L2_NORMALIZE)
        self.unit_norm = bool(cfg.MODEL.L2_NORMALIZE)

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
            if self.unit_norm and norm_err > 1e-4:
                raise AssertionError(f"{split}: |norm - 1| up to {norm_err}")
            EmbeddingCheck.seen.append((split, frames, norm_err))
        return 1.0


# the config's default EVAL.TASKS (their linear probes are the port's own,
# numpy + scipy: this machine has no sklearn), and the training runs' two
DEFAULT_TASKS = ("kendalls_tau", "retrieval", "classification", "event_completion")


def smoke_opts(extra=(), tasks=("kendalls_tau", "retrieval")):
    return ["DATA.NUM_WORKERS", "4", "EVAL.TASKS",
            f"[{','.join(tasks)},embedding_check]", *extra]


def phase_main_path(data_root, card):
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import (TASK_REGISTRY,
                                                         get_embeddings_dataset)
    from video_rep_learning_tpu_torch.models import build_model, save_checkpoint
    from video_rep_learning_tpu_torch.ops.attention import flash_attention_fwd

    logdir = os.path.join(WORK, "logs")
    argv = ["--workdir", data_root, "--logdir", logdir, "--cfg_file", CFG_FILE,
            "--device", "cuda", "--opts", *smoke_opts(tasks=DEFAULT_TASKS)]
    cfg = cli.load_config(cli.parse_cli(argv)[0])
    torch.manual_seed(SEED)
    save_checkpoint(build_model(cfg), logdir, 0)
    log("CARL model (configs/scl_transformer_config.yml, full width, seeded "
        "weights) saved as checkpoint_epoch_00000.pth")
    log(f"eval tasks: the default four ({', '.join(DEFAULT_TASKS)}; the "
        "probes are the port's numpy + scipy ones, and this machine has no "
        "sklearn) + this script's embedding check")

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
    if not set(DEFAULT_TASKS) <= set(metrics):
        raise AssertionError(f"the eval path ran {sorted(metrics)}, not the "
                             f"default tasks {DEFAULT_TASKS}")
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
                      what="CARL", opts=()):
    """The first `frames` frames of one val video through the eval sweep in
    fp32 (USE_AMP off, TF32 off) on the card and on the CPU, from the same
    checkpoint (the config with `opts`)."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation.embedding import \
        get_embeddings_dataset
    from video_rep_learning_tpu_torch.models import build_model, load_checkpoint

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", cfg_file, "--logdir", logdir, "--opts", "USE_AMP",
         "False", *opts])[0])
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
    from video_rep_learning_tpu_torch.ops import (attention, elementwise_chain,
                                                  int8_matmul, layernorm, matmul,
                                                  photometric, scl, vit_block)

    return {"flash_attn_fwd": attention.flash_attention_fwd,
            "flash_attn_bwd": attention.flash_attention_bwd,
            "crop_photometric": photometric.crop_photometric,
            "photometric": photometric.photometric,
            "layernorm": layernorm.fused_layernorm,
            "ln_gemm": matmul.ln_matmul_bias_act,
            "matmul_bias_gelu": matmul.matmul_bias_gelu,
            "ln_mlp_block": matmul.ln_mlp_block,
            "packed_attn": attention.packed_vit_attention,
            "vit_attention_block": vit_block.vit_attention_block,
            "scl_rowsum": scl.scl_rowsum, "scl_loss_rows": scl.scl_loss_rows,
            "scl_srow": scl.scl_srow, "scl_grad": scl.scl_grad,
            # the micro-benchmarks' kernels: no model path launches them
            "packed_attn_variant": attention.packed_attention_variant,
            "int8_gemm": int8_matmul.tc_matmul,
            "elementwise_chain": elementwise_chain.elementwise_chain}


def _reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


def warm_steps(trainer, n_steps):
    """(batch, ms per step, losses) of `n_steps` warm steps on one loaded
    batch, after one untimed, through the loop's own step function."""
    batch = next(iter(trainer.train_loader))
    trainer.train_step(batch, trainer.device_batch(batch), 9, 0, 1e-4)
    torch.cuda.synchronize()
    t0 = time.time()
    losses = [trainer.train_step(batch, trainer.device_batch(batch), 9, it + 1, 1e-4)
              for it in range(n_steps)]
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / n_steps * 1e3
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    return batch, step_ms, losses


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

    batch, step_ms, losses = warm_steps(trainer, 5)
    clips = batch["videos"].shape[0]
    log(f"train step (warm, USE_AMP bf16 backbone, {clips} clip x 2 views x "
        f"{trainer.cfg.TRAIN.NUM_FRAMES} frames of 256x256 uint8 -> 224 px, "
        f"H2D + augment + forward + backward + Adam): {step_ms:.1f} ms/step, "
        f"{clips / step_ms * 1e3:.2f} clips/s on {card}; losses {losses}")
    return trainer, batch, launches


def profile_train_step(trainer, batch, what, trace, own=None):
    """One warm step under torch.profiler: wall, device busy share, time by
    kernel (and by the `own` kernel-name fragments); the trace goes to
    WORK/`trace`."""
    from torch.profiler import ProfilerActivity, profile

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
    log(f"profile ({what}, one warm step): wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms = {busy / wall * 100:.1f}% (idle "
        f"{100 - busy / wall * 100:.1f}%)")
    if own:
        by = {label: 0.0 for label in own.values()}
        for e in events:
            for frag, label in own.items():
                if frag in e.key:
                    by[label] += e.self_device_time_total / 1e6
        rest, share = busy - sum(by.values()), 100 / max(busy, 1e-12)
        log("  device time by kind: " + ", ".join(
            f"{label} {t * 1e3:.1f} ms ({t * share:.1f}%)" for label, t in by.items())
            + f", everything else {rest * 1e3:.1f} ms ({rest * share:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    prof.export_chrome_trace(os.path.join(WORK, trace))


def phase_profile(trainer, batch):
    """One warm step under torch.profiler (device busy share, time by
    kernel), and one with CUDA events at the boundaries of its parts."""
    m = trainer.model
    profile_train_step(trainer, batch, "CARL", "train_step_trace.json",
                       {"flash_fwd_kernel": "flash_attn_fwd (encoder)",
                        "flash_bwd_mma_kernel": "flash_attn_bwd",
                        "crop_strip_kernel": "crop_photometric"})

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


def fp32_step_card_and_cpu(cfg_file, data_root, frames, seed, hook=None, opts=()):
    """One fp32 training step (USE_AMP False, TF32 off, dropout off) of
    `cfg_file`'s model at full width on the card and on the CPU, `frames` a
    view: the same initial weights, the loader's masks, lengths and steps
    with frames that differ in colour and contrast in place of the synthetic
    set's (mostly a flat background), and the same augmentation values
    sampled once on the host with jitter and blur on (the whole chain runs;
    a supervised config runs the jitters its AUGMENTATION turns on), through
    the config's algorithm. `hook(model)` may register hooks and returns a
    remover; `opts` are more config options. Returns
    (cfg, B, V, {device: (augmented frames, loss, head gradients)}), V 1
    for a supervised config."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.algos import get_algo
    from video_rep_learning_tpu_torch.data import construct_dataloader
    from video_rep_learning_tpu_torch.models import build_model, set_trainable
    from video_rep_learning_tpu_torch.ops.augment import (
        AugmentParams, SupervisedParams, sample_ssl_batch, sample_supervised_batch,
        ssl_batch_augment, supervised_batch_augment)

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", cfg_file, "--opts", "USE_AMP", "False", "TRAIN.NUM_FRAMES",
         str(frames), "DATA.NUM_WORKERS", "0", "MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE",
         "0.0", *opts])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, "pouring")
    loader, _ = construct_dataloader(cfg, "train")
    batch = next(iter(loader))
    videos = differing_frames(tuple(batch["videos"].shape), seed)
    gen = torch.Generator().manual_seed(SEED)
    if cfg.SSL:
        B, V, _, H, W, _ = batch["videos"].shape
        aug = AugmentParams(image_size=cfg.IMAGE_SIZE)
        sampled = sample_ssl_batch(gen, B, V, H, W, batch["dims"], aug)
        sampled["fscal"][:, [0, 5]] = 1
        augment = ssl_batch_augment
    else:
        (B, _, H, W, _), V = batch["videos"].shape, 1
        aug = SupervisedParams.from_cfg(cfg)
        sampled = sample_supervised_batch(gen, B, H, W, batch["dims"], aug)
        augment = supervised_batch_augment
    out = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(SEED)
        model = build_model(cfg, dev)
        set_trainable(model, cfg.MODEL.TRAIN_BASE)
        model.train()
        remove = hook(model) if hook else None
        tb = {"videos": torch.as_tensor(videos).to(dev)}
        for k in ("video_masks", "seq_lens", "chosen_steps"):
            tb[k] = torch.as_tensor(batch[k]).to(dev)
        tb["videos"] = augment(tb["videos"], sampled, aug)
        loss = get_algo(cfg).compute_loss(model, tb)["loss"]
        loss.backward()
        if remove:
            remove()
        out[dev] = (tb["videos"].float().cpu(), loss.item(), _head_grads(model))
        del model
    return cfg, B, V, out


def _rel(x, y, floor=1e-30):
    """max |x - y| relative to the largest |y|, at least `floor`."""
    return ((x.double() - y.double()).abs().max().item()
            / max(y.abs().max().item(), floor))


def _floor(grads):
    """STEP_TOL's floor: 1% of the largest gradient of `grads`."""
    return 1e-2 * max(g.abs().max().item() for g in grads)


def check_step(what, out, groups, held_elsewhere=()):
    """Log and check one card-vs-CPU step: frames, loss and each group of
    gradient tensors against STEP_TOL; the groups in `held_elsewhere` are
    logged only. Returns (ok, the CPU's gradients)."""
    (fa, la, ga), (fb, lb, gb) = out["cuda"], out["cpu"]
    f_err = (fa - fb).abs().max().item()
    l_err = abs(la - lb) / abs(lb)
    names = {g: [n for n in gb if n.startswith(p)] for g, p in groups}
    if sorted(sum(names.values(), [])) != sorted(gb) or set(ga) != set(gb):
        raise AssertionError(f"the gradient tensors do not match the groups: {sorted(gb)}")
    ok = f_err <= STEP_TOL["frames"] and l_err <= STEP_TOL["loss"]
    floor = _floor(gb[n] for g, ns in names.items() if g not in held_elsewhere
                   for n in ns)
    log(f"card vs CPU, {what}, TF32 off: frames err {f_err:.3e} (tol "
        f"{STEP_TOL['frames']:.0e}), loss {la:.6f} vs {lb:.6f} (rel {l_err:.2e}, "
        f"tol {STEP_TOL['loss']:.0e}); gradients, each tensor relative to its "
        f"largest value, at least {floor:.2e} (1% of the largest held one):")
    for group, ns in names.items():
        err, worst = max((_rel(ga[n], gb[n], floor), n) for n in ns)
        if group not in held_elsewhere:
            ok &= err <= STEP_TOL["grads"]
        log(f"  {group} ({len(ns)} tensors, largest |g| "
            f"{max(gb[n].abs().max().item() for n in ns):.3e}), fp32: worst {worst} "
            f"err {err:.2e} " + (f"(tol {STEP_TOL['grads']:.0e})"
                                 if group not in held_elsewhere else "(held in fp64 below)"))
    return ok, names


def phase_step_card_vs_cpu(data_root):
    """One fp32 CARL training step on the card and on the CPU, full width
    with 16 frames a view (`fp32_step_card_and_cpu`). Without USE_AMP the
    crop is the plain matmul and the photometric-only kernel runs. Then
    layer4 alone in fp64 on both devices, from the CPU step's layer3
    features and upstream gradient."""
    cap = {}
    _reset_launches()
    cfg, B, V, out = fp32_step_card_and_cpu(CFG_FILE, data_root, 16, SEED,
                                            capture_layer4(cap))
    launches = _read_launches()
    ok, groups = check_step(f"one fp32 training step ({B} clip x {V} views x 16 "
                            f"frames that differ, full width)", out, GRAD_GROUPS,
                            held_elsewhere=("layer4",))
    log(f"  photometric launches {launches['photometric']}")
    ok &= launches["photometric"] > 0
    ok &= layer4_card_vs_cpu(cfg, cap, out, groups["layer4"])
    log(f"card vs CPU training step {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's fp32 training step disagrees with the CPU's")
    return launches


def capture_layer4(cap):
    """A `hook` for `fp32_step_card_and_cpu`: keeps layer4's input and
    upstream gradient of the step in `cap`."""
    def install(model):
        def hook(mod, inp, feats):
            cap["x"] = inp[0].detach()
            feats.register_hook(lambda g: cap.__setitem__("g", g.detach()))
        return model.res_finetune.register_forward_hook(hook).remove
    return install


def layer4_card_vs_cpu(cfg, cap, out, names):
    """layer4 alone in fp64 on both devices, from the CPU step's layer3
    features and upstream gradient (`capture_layer4`) and the same initial
    weights: card vs CPU on STEP_TOL's layer4_fp64 rule; logs the fp32
    steps' layer4 gradients against these fp64 ones. Returns ok."""
    from video_rep_learning_tpu_torch.models import build_model

    g64 = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(SEED)
        layer4 = build_model(cfg, dev).res_finetune.double().train()
        layer4(cap["x"].to(dev, torch.float64)).backward(cap["g"].to(dev, torch.float64))
        g64[dev] = {"res_finetune." + n: p.grad.cpu() for n, p in layer4.named_parameters()}
    layer4 = names
    floor = _floor(g64["cpu"].values())
    e64, w64 = max((_rel(g64["cuda"][n], g64["cpu"][n], floor), n) for n in layer4)
    ok = e64 <= STEP_TOL["layer4_fp64"] and set(g64["cpu"]) == set(layer4)
    own = {dev: max(_rel(out[d][2][n], g64["cpu"][n], floor) for n in layer4)
           for dev, d in (("card", "cuda"), ("CPU", "cpu"))}
    log(f"  layer4 in fp64 on the CPU step's input and upstream gradient: "
        f"card vs CPU worst {w64} err {e64:.2e} (tol "
        f"{STEP_TOL['layer4_fp64']:.0e}); fp32 layer4 gradients against "
        f"these fp64 ones: the CPU's {own['CPU']:.2e}, the card's "
        f"{own['card']:.2e}")
    return ok


VIT_KERNELS = ("layernorm", "ln_gemm", "packed_attn", "vit_attention_block")


def _check_vit_blocks(what, launches):
    """A fully frozen ViT's launches, per chunk of 12 blocks: 1 final norm,
    12 half-blocks, each with one attention and two GEMMs, and 12 LN2 + fc1
    GEMMs."""
    blocks = launches["vit_attention_block"]
    if (blocks <= 0 or blocks != 12 * launches["layernorm"]
            or launches["packed_attn"] != blocks or launches["ln_gemm"] != 3 * blocks):
        raise AssertionError(f"{what}: ViT launches do not follow its blocks: {launches}")


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
    _check_vit_blocks("MV-Former eval", launches)
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
    fused = mvf_fused_mlp_sweep(cfg, model, loader, out, card)
    phase_mvf_profile(cfg, model, next(iter(loader)))
    return launches, logdir, fused


def mvf_fused_mlp_sweep(cfg, model, loader, default, card):
    """The same warm sweep with the MLP half-block on #9 (VRL_FUSED_MLP=1:
    one `ln_mlp_block` launch a block and chunk in place of #6's fc1 and
    fc2): its frames/s beside the default route's, its exact launches, and
    its embeddings (finite, unit norm, one a frame; their largest distance
    from the default route's is logged: the two routes round fc2's input
    at different points)."""
    from video_rep_learning_tpu_torch.evaluation import get_embeddings_dataset

    with env_vars(VRL_FUSED_MLP="1"):
        get_embeddings_dataset(cfg, model, loader, "cuda")  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.time()
        out = get_embeddings_dataset(cfg, model, loader, "cuda")
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = _read_launches()
    chunks, blocks = launches["layernorm"], launches["vit_attention_block"]
    if (chunks <= 0 or blocks != 12 * chunks or launches["ln_mlp_block"] != blocks
            or launches["ln_gemm"] != 2 * blocks):
        raise AssertionError(f"VRL_FUSED_MLP=1 sweep: launches do not follow the "
                             f"ViT's blocks: {launches}")
    embs, want = np.concatenate(out["embs"]), np.concatenate(default["embs"])
    frames = sum(out["seq_lens"])
    norm_err = float(np.abs(np.linalg.norm(embs, axis=1) - 1).max())
    if (embs.shape != want.shape or embs.shape[0] != frames
            or not np.isfinite(embs).all() or norm_err > 1e-4):
        raise AssertionError(f"VRL_FUSED_MLP=1 sweep: bad embeddings {embs.shape}, "
                             f"|norm - 1| up to {norm_err}")
    diff = float(np.abs(embs - want).max())
    log(f"MV-Former embedding sweep under VRL_FUSED_MLP=1 (val, warm, {frames} "
        f"frames): {frames / dt:.1f} frames/s in {dt:.3f} s on {card}; "
        f"ln_mlp_block {launches['ln_mlp_block']} launches ({chunks} chunks x 12), "
        f"max |norm - 1| {norm_err:.2e}, max |emb - default route's| {diff:.3e}")
    return dict(frames_per_s=frames / dt, launches=launches["ln_mlp_block"],
                chunks=chunks, max_abs_diff_default=diff)


# kernel-name fragments of the port's ViT kernels (the wrappers' CUDA
# functions) in a profile
OWN_KERNELS = {"ln_gemm_wgmma_kernel": "ln_gemm (#6, #5's qkv and proj)",
               "packed_attn_wgmma_kernel": "packed_attn (#4)",
               "layernorm_kernel": "layernorm (#8)",
               "flash_fwd_mma_kernel": "flash_attn_fwd (encoder)"}


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


def _peak_mib(fn):
    """fn's peak device memory above what was allocated before it, MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


SCL_PASSES = ("scl_rowsum", "scl_loss_rows", "scl_srow", "scl_grad")
SCL_WORK = dict(zip(SCL_PASSES, ("rowsum", "loss", "srow", "grad")))  # bounds.scl_fused's


def phase_scl_kernels():
    """The fused SCL kernels (#10) against their plain versions at every
    SCL_SHAPES size and negative type: the tiles they walk (`scl_tiles`)
    against `work_pairs`' per tile, each pass's rows (bit for bit on a
    second launch and when walking every tile), then the loss and the
    gradient through `scl_loss_fused` against `scl_sequence_loss`; each pass
    timed beside its plain version and its bound at N = 480 (the pouring_mvf
    step; both negative types) and 8640 (the auto gate's reach); loss +
    gradient and the peak memory of the plain and fused ones at 8640; the
    auto gate at 8640."""
    from video_rep_learning_tpu_torch.algos.scl import (scl_loss_dispatch,
                                                        scl_sequence_loss)
    from video_rep_learning_tpu_torch.ops import bounds, scl

    entries = {}
    for B, T in SCL_SHAPES:
        N = B * 2 * T
        for neg in SCL_NEGATIVES:
            e4, lens, steps, masks = scl.sample_inputs(B, T, seed=N, device="cuda")
            C = e4.shape[-1]
            p = dict(temperature=0.1, label_varience=10.0,
                     single="single" in neg, noself="noself" in neg)
            e, meta = scl.pad_inputs(e4.reshape(N, C), scl.build_meta(lens, steps, masks),
                                     scl.block_layout(N))
            # the tiles the passes walk, from the metadata, against the same
            # flags taken from `work_pairs` tile by tile
            flags = dict(single=p["single"], noself=p["noself"])
            tiles = scl.scl_tiles(meta, B, 2, **flags)
            if not torch.equal(tiles, scl.tiles_reference(meta, **flags)):
                raise AssertionError(f"scl_tiles disagrees with work_pairs at N={N} {neg}")
            rows = scl.scl_rowsum(e, meta, tiles, **p)
            s = scl.scl_srow(e, meta, rows, tiles, **p)
            # each pass and its plain version on the kernels' own rows and S
            calls = {"scl_rowsum": (lambda t=tiles: scl.scl_rowsum(e, meta, t, **p),
                                    lambda: scl.rowsum_reference(e, meta, **p)),
                     "scl_loss_rows": (lambda t=tiles: scl.scl_loss_rows(e, meta, rows, t, **p),
                                       lambda: scl.loss_rows_reference(e, meta, rows, **p)),
                     "scl_srow": (lambda t=tiles: scl.scl_srow(e, meta, rows, t, **p),
                                  lambda: scl.srow_reference(e, meta, rows, **p)),
                     "scl_grad": (lambda t=tiles: scl.scl_grad(e, meta, rows, s, t, **p),
                                  lambda: scl.grad_reference(e, meta, rows, s, **p))}
            got = {"scl_rowsum": rows, "scl_loss_rows": calls["scl_loss_rows"][0](),
                   "scl_srow": s, "scl_grad": calls["scl_grad"][0]()}
            # a second launch, and a walk over every tile, give the same bits
            same = all(torch.equal(got[k], calls[k][0]()) for k in SCL_PASSES)
            every = all(torch.equal(got[k], calls[k][0](None)) for k in SCL_PASSES)
            torch.cuda.synchronize()
            plain = {k: ref() for k, (_, ref) in calls.items()}
            # negsum and possum each against its own largest value
            errs = {k: max(_rel(got[k][:, c], plain[k][:, c]) for c in (0, 1))
                    if k == "scl_rowsum" else _rel(got[k], plain[k]) for k in SCL_PASSES}
            abs_errs = {k: (got[k] - plain[k]).abs().max().item() for k in SCL_PASSES}
            fused_e, plain_e = (e4.clone().requires_grad_() for _ in range(2))
            fused = scl.scl_loss_fused(fused_e, lens, steps, masks, 0.1, 10.0, neg)
            fused.backward()
            ref = scl_sequence_loss(plain_e, lens, steps, masks, temperature=0.1,
                                    label_varience=10.0, negative_type=neg)["loss"]
            ref.backward()
            l_err = abs(fused.item() - ref.item()) / abs(ref.item())
            g_err = _rel(fused_e.grad, plain_e.grad)
            ok = (all(errs[k] <= SCL_TOL["grad" if k == "scl_grad" else "rows"]
                      for k in SCL_PASSES)
                  and l_err <= SCL_TOL["loss"] and g_err <= SCL_TOL["grad"]
                  and all(bool(torch.isfinite(t).all()) for t in got.values())
                  and not rows[N:].any() and not got["scl_grad"][N:].any()
                  and same and every)
            kept = [(tiles & bit).bool().float().mean().item() * 100 for bit in (1, 2)]
            log(f"kernel vs plain scl N={N} ({B}x2x{T}) {neg}: rows/loss/S/grad "
                f"passes err " + "/".join(f"{errs[k]:.2e}" for k in SCL_PASSES)
                + f" of the largest value (tol {SCL_TOL['rows']:.0e}, grad "
                f"{SCL_TOL['grad']:.0e}); loss {fused.item():.6f} vs {ref.item():.6f} "
                f"(rel {l_err:.2e}, tol {SCL_TOL['loss']:.0e}); dL/de err {g_err:.2e} "
                f"(tol {SCL_TOL['grad']:.0e}); a second launch "
                f"{'bit-identical' if same else 'DIFFERS'}, every tile walked "
                f"{'bit-identical' if every else 'DIFFERS'}; tiles walked {kept[0]:.1f}% "
                f"(passes 1, 4), {kept[1]:.1f}% (2, 3) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the fused SCL kernels disagree at N={N} {neg}")
            if N not in (480, 8640) or (N == 8640 and neg != "single_noself"):
                continue
            # times beside the plain passes and the bound of the pairs these
            # inputs need: every pair with a negative weight or a positive
            # label for passes 1 and 4, the positives alone for 2 and 3
            pairs, positives = (int(m.sum()) for m in scl.work_pairs(meta, **flags))
            work = bounds.scl_fused(N, C, pairs=pairs, positives=positives)
            for name in SCL_PASSES:
                ms, plain_ms, _, host_ms = timed(*calls[name])
                b_ms, b_by = bounds.bound(*work[SCL_WORK[name]])
                log(f"time {name} N={N} {neg} fp32: kernel {ms:.4f} ms "
                    f"(host {host_ms:.4f} ms a call), "
                    f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                    f"{positives if SCL_WORK[name] in ('loss', 'srow') else pairs} of "
                    f"{N * N} pairs; the kernel at {b_ms / ms * 100:.1f}% of it), "
                    f"library none")
                timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
                if N == 480 and neg == "single_noself":  # the MV-Former training step's
                    entries[name] = dict(timing, library_ms=None, host_ms=host_ms,
                                         max_abs_err=abs_errs[name])
                else:
                    entries.setdefault(name, {})[f"at_N{N}_{neg}"] = timing
            if neg != "single_noself":
                continue

            def fused_step():
                x = e4.clone().requires_grad_()
                scl.scl_loss_fused(x, lens, steps, masks, 0.1, 10.0, neg).backward()

            def plain_step():
                x = e4.clone().requires_grad_()
                scl_sequence_loss(x, lens, steps, masks, temperature=0.1,
                                  label_varience=10.0, negative_type=neg)["loss"].backward()

            f_ms, p_ms, _, _ = timed(fused_step, plain_step)
            fb = [bounds.bound(*work[k])[0] for k in ("forward", "backward")]
            log(f"time fused SCL loss + gradient N={N}: kernels {f_ms:.4f} ms, plain "
                f"scl_sequence_loss + autograd {p_ms:.4f} ms, bound {sum(fb):.4f} ms "
                f"(forward {fb[0]:.4f}, backward {fb[1]:.4f}; operations)")
            entries["scl_grad"][f"at_N{N}_loss_grad"] = dict(ms=f_ms, plain_ms=p_ms,
                                                             bound_ms=sum(fb))
            if N == 8640:
                mem = {k: _peak_mib(f) for k, f in (("plain", plain_step),
                                                    ("fused", fused_step))}
                log(f"peak device memory of loss + gradient at N={N}: plain "
                    f"{mem['plain']:.1f} MiB, fused {mem['fused']:.1f} MiB "
                    f"(torch.cuda.max_memory_allocated above the inputs)")
                entries["scl_grad"][f"at_N{N}_loss_grad"]["peak_mib"] = mem["fused"]
                # the auto gate (VRL_FUSED_SCL unset) takes the kernels here
                saved = os.environ.pop("VRL_FUSED_SCL", None)
                try:
                    _reset_launches()
                    x = e4.clone().requires_grad_()
                    scl_loss_dispatch(x, lens, steps, masks, temperature=0.1,
                                      label_varience=10.0, positive_type="gauss",
                                      negative_type=neg).backward()
                    torch.cuda.synchronize()
                    gate = {k: v for k, v in _read_launches().items() if k in SCL_PASSES}
                finally:
                    if saved is not None:
                        os.environ["VRL_FUSED_SCL"] = saved
                log(f"auto gate (VRL_FUSED_SCL unset) at N={N}: launches {json.dumps(gate)}")
                if any(v != 1 for v in gate.values()):
                    raise AssertionError(f"the auto gate did not take the kernels at N={N}")
            del e, meta, rows, s, plain, got, calls, tiles
            torch.cuda.empty_cache()
    return entries


def seeded_mvf_checkpoint(cfg):
    """A reference-layout `.pth` of seeded full-width MV-Former weights (the
    DINO weights are not in the repository), and its state dict."""
    from video_rep_learning_tpu_torch.models import build_model, save_checkpoint

    torch.manual_seed(SEED)
    model = build_model(cfg)
    path = save_checkpoint(model, os.path.join(WORK, "mvf_seed"), 0)
    return path, model.state_dict()


def phase_mvf_train_path(data_root, card):
    """`python -m video_rep_learning_tpu_torch.train` on
    configs_mvf/pouring_mvf.yml at full width under VRL_FUSED_SCL=1, warm
    started from a seeded checkpoint: one epoch over the 6 train videos with
    a checkpoint, then `--continue_train` for a second; then warm steps and
    a profiled one, under the same flag."""
    with env_vars(VRL_FUSED_SCL="1"):
        return _mvf_train_path(data_root, card)


def _mvf_train_path(data_root, card):
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import TASK_REGISTRY
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    logdir = os.path.join(WORK, "mvf_train_logs")
    cfg = cli.load_config(cli.parse_cli(["--cfg_file", MVF_CFG_FILE])[0])
    seed_path, seed_state = seeded_mvf_checkpoint(cfg)

    def argv(epochs, *flags):
        return ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                MVF_CFG_FILE, "--device", "cuda", *flags, "--opts", *smoke_opts(
                    ["TRAIN.MAX_EPOCHS", str(epochs), "LOGGING.REPORT_INTERVAL",
                     "3", "RNG_SEED", str(SEED), "MODEL.PRETRAINED_CHECKPOINT",
                     seed_path])]

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    EmbeddingCheck.seen = []
    _reset_launches()
    t0 = time.time()
    train_main(argv(1))
    torch.cuda.synchronize()
    log(f"MV-Former train path: epoch 0 in {time.time() - t0:.2f} s cold "
        f"(build, warm start, loaders, 6 steps, checkpoint, val loss, evaluation)")
    ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
    if ckpts != ["checkpoint_epoch_00000.pth"]:
        raise AssertionError(f"expected one epoch-0 checkpoint, found {ckpts}")
    t0 = time.time()
    trainer = train_main(argv(2, "--continue_train", "--tempcfg"))
    torch.cuda.synchronize()
    launches = _read_launches()
    steps = 2 * len(trainer.train_loader)
    log(f"MV-Former train path: resumed at epoch {trainer.start_epoch}, epoch 1 in "
        f"{time.time() - t0:.2f} s; {steps} training steps; launches on the path "
        f"{json.dumps(launches)}")
    if trainer.start_epoch != 1:
        raise AssertionError("the second run did not resume from epoch 0")
    _check_vit_blocks("MV-Former training", launches)
    for name in ("crop_photometric", "flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"the MV-Former training path never launched {name}")
    # every forward (training, val loss) runs passes 1-2, every backward 3-4
    if (launches["scl_rowsum"] != launches["scl_loss_rows"]
            or launches["scl_srow"] != steps or launches["scl_grad"] != steps
            or launches["scl_rowsum"] < steps):
        raise AssertionError(f"the fused SCL launches do not follow the steps: {launches}")
    if len(EmbeddingCheck.seen) != 4:
        raise AssertionError("the embedding check did not run after each epoch")

    # exactly the trainable tensors moved; the ViT is bit-identical
    trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    moved = vit = vit_moved = 0
    for n, v in trainer.model.state_dict().items():
        same = torch.equal(v.cpu(), seed_state[n])
        if n in trainable:
            moved += not same
        elif n.startswith("backbone."):
            vit += 1
            vit_moved += not same
    log(f"MV-Former train path: {moved} of {len(trainable)} trainable tensors moved, "
        f"{vit_moved} of {vit} backbone.* tensors moved")
    if moved != len(trainable) or vit_moved or not vit or any(
            n.startswith("backbone.") for n in trainable):
        raise AssertionError("the wrong MV-Former parameters moved")

    batch, step_ms, losses = warm_steps(trainer, 3)
    clips = batch["videos"].shape[0]
    log(f"MV-Former train step (warm, bf16 ViT-B/8, {clips} clip x 2 views x "
        f"{trainer.cfg.TRAIN.NUM_FRAMES} frames of 256x256 uint8 -> 224 px, H2D + "
        f"augment + ViT + head + fused SCL + backward + Adam; VRL_FUSED_SCL "
        f"{os.environ.get('VRL_FUSED_SCL', 'auto')}): {step_ms:.1f} ms/step, "
        f"{clips / step_ms * 1e3:.3f} clips/s on {card}; losses {losses}")
    own = dict(OWN_KERNELS, **{f"scl_pass_kernel<{i}>": "fused SCL passes 1-3"
                               for i in range(3)},
               **{"scl_pass_kernel<3>": "fused SCL pass 4",
                  "scl_sum_splits_kernel": "fused SCL split sums"},
               flash_bwd_mma_kernel="flash_attn_bwd",
               crop_strip_kernel="crop_photometric")
    profile_train_step(trainer, batch, "MV-Former", "mvf_train_step_trace.json", own)
    return launches


def _head_grads(model):
    return {n: p.grad.detach().float().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def phase_mvf_fused_vs_plain(data_root):
    """One step of k400_mvf.yml's model and loss (SMART_FEATS 3,7,11,
    batch_noself, 2 clips x 2 views x 80 frames; its dataset keys pointed at
    the synthetic Pouring set) under VRL_FUSED_SCL=1 and then 0, on the same
    weights, batch, augmentation and dropout: the loss and every head
    gradient agree, and only the first runs the #10 kernels."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.train import Trainer

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", K400_MVF_CFG_FILE, "--opts", "DATASETS", "[pouring]",
         "PATH_TO_DATASET", "pouring", "TRAIN.BATCH_SIZE", "2",
         "DATA.NUM_WORKERS", "0", "RNG_SEED", str(SEED)])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, "pouring")
    trainer = Trainer(cfg, no_eval=True, device="cuda")
    trainer.train_loader.set_epoch(0)
    batch = next(iter(trainer.train_loader))
    dev = trainer.device_batch(batch)
    videos = trainer.augment(batch, dev, 0, 0, 0)
    B, V, T = dev["video_masks"].shape
    out = {}
    for flag in ("1", "0"):
        with env_vars(VRL_FUSED_SCL=flag):
            trainer.model.train()
            trainer.optimizer.zero_grad()
            _reset_launches()
            torch.manual_seed(SEED)  # the same dropout in both steps
            loss = trainer.algo.compute_loss(trainer.model,
                                             dict(dev, videos=videos))["loss"]
            loss.backward()
            torch.cuda.synchronize()
            scl_launches = {k: v for k, v in _read_launches().items() if k in SCL_PASSES}
            out[flag] = (loss.item(), _head_grads(trainer.model), scl_launches)
    (lf, gf, nf), (lp, gp, np_) = out["1"], out["0"]
    l_err = abs(lf - lp) / abs(lp)
    # a tensor whose gradient is 0 in exact arithmetic (the attention key
    # biases: softmax ignores a shift shared by every key) holds rounding
    # noise only: STEP_TOL's floor
    floor = _floor(gp.values())
    errs = {n: _rel(gf[n], gp[n], floor) for n in gp}
    worst = max(errs, key=errs.get)
    ok = (l_err <= FUSED_STEP_TOL["loss"] and set(gf) == set(gp)
          and errs[worst] <= FUSED_STEP_TOL["grads"]
          and all(v == 1 for v in nf.values()) and not any(np_.values())
          and not any(n.startswith("backbone.") for n in gp))
    log(f"fused vs plain SCL in one MV-Former step (k400_mvf.yml: SMART_FEATS "
        f"{cfg.MODEL.EMBEDDER_MODEL.SMART_FEATS}, {cfg.SCL.NEGATIVE_TYPE}, {B} clips x "
        f"{V} views x {T} frames = N {B * V * T}): loss {lf:.6f} vs {lp:.6f} (rel "
        f"{l_err:.2e}, tol {FUSED_STEP_TOL['loss']:.0e}); {len(gp)} head gradient "
        f"tensors, worst {worst} {errs[worst]:.2e} of its largest value, at least "
        f"{floor:.2e} (tol "
        f"{FUSED_STEP_TOL['grads']:.0e}); #10 launches fused {json.dumps(nf)}, plain "
        f"{json.dumps(np_)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused and plain SCL steps disagree")


def phase_mvf_step_card_vs_cpu(data_root):
    """One fp32 MV-Former training step on the card and on the CPU
    (`fp32_step_card_and_cpu`): the full-width ViT-B/8 on MVF_STEP_FRAMES
    frames a view, every head gradient tensor held."""
    _, B, V, out = fp32_step_card_and_cpu(MVF_CFG_FILE, data_root, MVF_STEP_FRAMES,
                                          SEED + 1)
    ok, _ = check_step(f"one fp32 MV-Former training step ({B} clip x {V} views x "
                       f"{MVF_STEP_FRAMES} frames that differ, full-width ViT-B/8)",
                       out, MVF_GRAD_GROUPS)
    log(f"card vs CPU MV-Former training step {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's fp32 MV-Former step disagrees with the CPU's")


# the partially frozen ViT: configs_mvf/pouring_mvf.yml with blocks 0-9
# frozen, blocks 10-11 and the final norm trained, under MODEL.REMAT
PARTIAL_FRONT = 10
PARTIAL_OPTS = ["MODEL.BASE_MODEL.LAYER", str(PARTIAL_FRONT), "MODEL.REMAT", "True"]
# the MLP half-block's extra launches a block on each route of the JAX gates
# (models/vit.py::mlp_route): (ln_gemm, ln_mlp_block, matmul_bias_gelu,
# layernorm); every block also makes one #5 = one #4 + two ln_gemm
MLP_ROUTES = {"fused_mlp": (0, 1, 0, 0), "ln_mm": (1, 0, 0, 0), "mm": (0, 0, 1, 1)}


def partial_step_launches(route, frames, chunk=40, depth=12, front=PARTIAL_FRONT,
                          remat=True):
    """The ViT kernels' launches of one training step of the partial ViT:
    the front's blocks once per chunk of `chunk` frames, the back end's on
    all the frames at once, once more under REMAT (the recompute), and its
    final norm with each."""
    back_runs = 2 if remat else 1
    blocks = front * -(-frames // chunk) + (depth - front) * back_runs
    gemm, mlp, mm, ln = MLP_ROUTES[route]
    return {"vit_attention_block": blocks, "packed_attn": blocks,
            "ln_gemm": (2 + gemm) * blocks, "ln_mlp_block": mlp * blocks,
            "matmul_bias_gelu": mm * blocks, "layernorm": ln * blocks + back_runs,
            "packed_attn_variant": 0}


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_partial_train_path(data_root, card):
    """`python -m video_rep_learning_tpu_torch.train` on pouring_mvf.yml with
    MODEL.BASE_MODEL.LAYER 10 and MODEL.REMAT True at full width, warm
    started from the seeded fully frozen checkpoint: under VRL_FUSED_MLP=1
    one epoch with a checkpoint, then `--continue_train` for a second; then
    one warm step under each MLP route of the JAX gates (#9, the default #6,
    VRL_FUSED_LN_MM=0's #8 + #7) with its launches and peak memory; then
    warm steps and a profiled one under VRL_FUSED_MLP=1. Returns the
    launches summed over the phase."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import TASK_REGISTRY
    from video_rep_learning_tpu_torch.models.weights import split_vit_state
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    logdir = os.path.join(WORK, "partial_train_logs")
    cfg = cli.load_config(cli.parse_cli(["--cfg_file", MVF_CFG_FILE])[0])
    seed_path, seed_state = seeded_mvf_checkpoint(cfg)
    seed_state = split_vit_state(seed_state, PARTIAL_FRONT)

    def argv(epochs, *flags):
        return ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                MVF_CFG_FILE, "--device", "cuda", *flags, "--opts", *smoke_opts(
                    ["TRAIN.MAX_EPOCHS", str(epochs), "LOGGING.REPORT_INTERVAL",
                     "3", "RNG_SEED", str(SEED), "MODEL.PRETRAINED_CHECKPOINT",
                     seed_path, *PARTIAL_OPTS])]

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    EmbeddingCheck.seen = []
    total = {}
    with env_vars(VRL_FUSED_MLP="1"):
        _reset_launches()
        t0 = time.time()
        train_main(argv(1))
        torch.cuda.synchronize()
        log(f"partial-ViT train path (LAYER {PARTIAL_FRONT}, REMAT, VRL_FUSED_MLP=1): "
            f"epoch 0 in {time.time() - t0:.2f} s cold (build, warm start from the "
            f"fully frozen checkpoint, loaders, 6 steps, checkpoint, val loss, "
            f"evaluation)")
        ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
        if ckpts != ["checkpoint_epoch_00000.pth"]:
            raise AssertionError(f"expected one epoch-0 checkpoint, found {ckpts}")
        t0 = time.time()
        trainer = train_main(argv(2, "--continue_train", "--tempcfg"))
        torch.cuda.synchronize()
        launches = _read_launches()
    _add(total, launches)
    steps = 2 * len(trainer.train_loader)
    log(f"partial-ViT train path: resumed at epoch {trainer.start_epoch}, epoch 1 "
        f"in {time.time() - t0:.2f} s; {steps} training steps; launches on the "
        f"path {json.dumps(launches)}")
    if trainer.start_epoch != 1:
        raise AssertionError("the second run did not resume from epoch 0")
    blocks = launches["vit_attention_block"]
    if (blocks <= 0 or launches["packed_attn"] != blocks
            or launches["ln_gemm"] != 2 * blocks or launches["ln_mlp_block"] != blocks
            or launches["matmul_bias_gelu"] or launches["layernorm"] <= 0):
        raise AssertionError(f"ViT launches do not follow #9's route: {launches}")
    for name in ("crop_photometric", "flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"the partial-ViT path never launched {name}")
    if len(EmbeddingCheck.seen) != 4:
        raise AssertionError("the embedding check did not run after each epoch")

    # the back end and the head moved, the front is bit-identical. The final
    # norm only feeds the CLS feature, which pouring_mvf's head never reads:
    # its bias has no gradient and no weight decay to move it
    trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    still = {"res_finetune.norm.bias"}
    moved, front, front_moved = set(), 0, 0
    for n, v in trainer.model.state_dict().items():
        same = torch.equal(v.cpu(), seed_state[n])
        if n in trainable and not same:
            moved.add(n)
        elif n.startswith("backbone."):
            front += 1
            front_moved += not same
    back = sorted(n for n in trainable if n.startswith("res_finetune."))
    log(f"partial-ViT train path: {len(moved)} of {len(trainable)} trainable tensors "
        f"moved ({len(back)} res_finetune.*, blocks "
        f"{sorted({n.split('.')[2] for n in back if '.blocks.' in n})}; unmoved "
        f"{sorted(trainable - moved)}), {front_moved} of {front} backbone.* tensors "
        f"moved")
    if (trainable - moved != still or front_moved or not front
            or any(n.startswith("backbone.") for n in trainable)
            or not any(n.startswith("res_finetune.blocks.11.") for n in moved)):
        raise AssertionError("the wrong partial-ViT parameters moved")

    # one warm step on each MLP route: launches, time, peak memory
    batch = next(iter(trainer.train_loader))
    frames = batch["videos"].shape[0] * batch["videos"].shape[1] * trainer.cfg.TRAIN.NUM_FRAMES
    for i, (route, env) in enumerate((("fused_mlp", {"VRL_FUSED_MLP": "1"}),
                                      ("ln_mm", {}), ("mm", {"VRL_FUSED_LN_MM": "0"}))):
        with env_vars(**env):
            dev = trainer.device_batch(batch)
            torch.cuda.synchronize()
            _reset_launches()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            loss = float(trainer.train_step(batch, dev, 9, 100 + i, 1e-4))
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            counts = _read_launches()
        _add(total, counts)
        want = partial_step_launches(route, frames)
        got = {k: counts[k] for k in want}
        ok = got == want and np.isfinite(loss)
        log(f"partial-ViT step, MLP route {route} ({' '.join(f'{k}={v}' for k, v in env.items()) or 'default gates'}): "
            f"{ms:.1f} ms, peak device memory {peak:.2f} GiB above the "
            f"{base / 2 ** 30:.2f} GiB held, loss {loss:.6f}; ViT launches {json.dumps(got)} "
            f"(expected {json.dumps(want)}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {route} route's step launched the wrong kernels")

    with env_vars(VRL_FUSED_MLP="1"):
        _reset_launches()
        batch, step_ms, losses = warm_steps(trainer, 3)
        clips = batch["videos"].shape[0]
        log(f"partial-ViT train step (warm, bf16 ViT-B/8 frozen to block "
            f"{PARTIAL_FRONT}, blocks 10-11 + norm trained under REMAT, VRL_FUSED_MLP=1, "
            f"{clips} clip x 2 views x {trainer.cfg.TRAIN.NUM_FRAMES} frames of 256x256 "
            f"uint8 -> 224 px): {step_ms:.1f} ms/step, {clips / step_ms * 1e3:.3f} "
            f"clips/s on {card}; losses {losses}")
        own = dict(OWN_KERNELS, mlp_wgmma_kernel="ln_mlp_block (#9)",
                   flash_bwd_mma_kernel="flash_attn_bwd",
                   crop_strip_kernel="crop_photometric")
        profile_train_step(trainer, batch, "partial ViT", "partial_train_step_trace.json",
                           own)
        _add(total, _read_launches())
    return total


def phase_partial_step_card_vs_cpu(data_root):
    """One fp32 training step of the partial ViT (LAYER 10, REMAT) on the
    card and on the CPU (`fp32_step_card_and_cpu`, MVF_STEP_FRAMES frames a
    view), under the default gates and under VRL_FUSED_MLP=1: every head
    gradient tensor and every `res_finetune` one held on STEP_TOL's rule."""
    groups = MVF_GRAD_GROUPS + (("ViT back end", ("res_finetune.",)),)
    for what, env in (("default gates", {}), ("VRL_FUSED_MLP=1", {"VRL_FUSED_MLP": "1"})):
        with env_vars(**env):
            _reset_launches()
            _, B, V, out = fp32_step_card_and_cpu(MVF_CFG_FILE, data_root,
                                                  MVF_STEP_FRAMES, SEED + 2,
                                                  opts=PARTIAL_OPTS)
            launches = _read_launches()
        ok, names = check_step(
            f"one fp32 partial-ViT training step ({B} clip x {V} views x "
            f"{MVF_STEP_FRAMES} frames that differ, ViT-B/8 frozen to block "
            f"{PARTIAL_FRONT}, REMAT, {what})", out, groups)
        ok &= len(names["ViT back end"]) > 0 and (
            launches["ln_mlp_block"] > 0 if env else launches["ln_gemm"] > 0)
        log(f"card vs CPU partial-ViT training step, {what}: "
            f"{len(names['ViT back end'])} res_finetune gradient tensors; ln_mlp_block "
            f"launches {launches['ln_mlp_block']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the card's fp32 partial-ViT step disagrees with "
                                 f"the CPU's ({what})")


# Phase 14: the port's counterparts of the TPU micro-benchmarks of tools/
# (row 13), each through its entry point `run("cuda")` at the TPU script's
# shapes. Every row holds the kernel against its own plain version on the
# same inputs on the card; the tolerances live beside each tool and are:
# - #6 (the rows of both TPU schedules) and #8 + #7 against #6's plain
#   version: one bf16 ulp of the largest value (both round the LN output
#   and the activation at the same points, as #6 is held);
# - each attention variant against its own variant's plain version (its
#   clamp, exp or exp2, bf16 P, l from rounded or unrounded p, the full-row
#   max for the max-subtracted forms): two bf16 ulps of the largest output,
#   as #4 (a max-subtracted kernel rounds p against a running max, the plain
#   version against the full-row one); and each plain version against the
#   exact fp32 softmax on two images at two bf16 ulps of the exact output's
#   largest value (P and the output round to bf16). The outputs are means
#   of 785 values of 0.3 randn, at most ~0.06, so no limit is floored at 1;
# - the int8 GEMM bit for bit (exact int32 sums on both sides); the bf16 one
#   at 1e-5 of the largest value (exact bf16 products, fp32 sums in another
#   order over K = 768);
# - the elementwise chain bit for bit in all three modes (every op rounds
#   once on both sides: __fmul_rn / __fadd_rn in fp32, the bf16x2
#   intrinsics in bf16).
TOOLS = ("bench_ln_matmul", "bench_packed_attn", "bench_attn_variants",
         "bench_int8_pallas", "bench_vpu_bf16")
# kernel entry: (tool, its row whose numbers the kernels line carries)
TOOL_ENTRIES = {"packed_attn_variant": ("bench_packed_attn", "nomax+exp2"),
                "int8_gemm": ("bench_int8_pallas", "int8 (tc_matmul)"),
                "elementwise_chain": ("bench_vpu_bf16", "fp32 in, fp32 math")}


def phase_tools(card):
    """14: each micro-benchmark's `run("cuda")` at the TPU scripts' full
    shapes, its rows held and printed; returns the tool kernels' entries
    (and #6's rows under "ln_gemm_tools") and every kernel's launches over
    the phase (each tool's check launch and its timed launches)."""
    import importlib

    from video_rep_learning_tpu_torch.tools import bench_vpu_bf16, common

    _reset_launches()
    rows = {}
    for name in TOOLS:
        tool = importlib.import_module(f"video_rep_learning_tpu_torch.tools.{name}")
        t0 = time.time()
        rows[name] = tool.run("cuda")
        log(f"tools.{name} (the TPU script tools/{name}.py's shapes) on {card}, "
            f"{time.time() - t0:.1f} s:")
        common.show(rows[name])
        torch.cuda.empty_cache()
        bad = [r["name"] for r in rows[name] if not r["ok"]]
        if bad:
            raise AssertionError(f"tools.{name}: {bad} disagree with their plain "
                                 "versions")
    with open(os.path.join(WORK, "tools_rows.json"), "w") as f:
        json.dump(rows, f)
    launches = {k: n for k, n in _read_launches().items() if n}
    log(f"tools: launches {launches} (#6, #7, #8 and #4 as the TPU scripts' "
        "shipped rows)")
    entries = {}
    for kernel, (tool, which) in TOOL_ENTRIES.items():
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"phase 14 never launched {kernel}")
        by_name = {r["name"]: r for r in rows[tool]}
        r = by_name[which]
        entries[kernel] = dict(
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], host_ms=r["host_ms"],
            max_abs_err=r["err"],
            row=which, rows_ms={x["name"]: x["ms"] for x in rows[tool]},
            rows_err={x["name"]: x["err"] for x in rows[tool]})
        if kernel == "packed_attn_variant":
            entries[kernel]["rows_ms_b160"] = {
                x["name"]: x["ms"] for x in rows["bench_attn_variants"]}
        if kernel == "elementwise_chain":
            entries[kernel]["slopes_ms"] = {
                x["name"]: dict(reps_6_480=x["slope_ms"], spread=x["slope_spread_ms"],
                                reps_6_48=x["slope_6_48_ms"]) for x in rows[tool]}
            # NaN, ±inf and out-of-range values, each mode (a row is ok only with it)
            entries[kernel]["special_ok"] = {x["name"]: x["special_ok"] for x in rows[tool]}
            log(f"elementwise_chain on NaN / ±inf / out-of-range values at REPS "
                f"{bench_vpu_bf16.SPECIAL_REPS}: {entries[kernel]['special_ok']}")
    # rows 13a and 13b: both TPU schedules' rows run #6
    entries["ln_gemm_tools"] = dict(
        rows_ms={x["name"]: x["ms"] for x in rows["bench_ln_matmul"]},
        rows_err={x["name"]: x["err"] for x in rows["bench_ln_matmul"]})
    return entries, launches


# Phase 15: the supervised paths (TCC, TCN, classification; the conv
# embedder and the NUM_CONTEXTS 2 eval sweep) at full width over the
# synthetic set, through the trainer and the evaluation CLI
SUP_CFGS = {name: os.path.join(REPO, "configs", f"{name}.yml")
            for name in ("tcc_transformer_config", "tcc_config", "tcn_config",
                         "classification_transformer_config", "scl_config")}
TCC_STEP_FRAMES = 96  # a clip, for the card vs CPU fp32 TCC step
# TCC pairs a batch's clips: a val batch of one raises in both packages, and
# the shipped TCC configs leave EVAL.BATCH_SIZE at 1
TCC_OPTS = ("EVAL.BATCH_SIZE", "2")


def sup_cfg(name, data_root, logdir, opts=()):
    """The config as `python -m video_rep_learning_tpu_torch.train` loads it,
    over the synthetic set."""
    from video_rep_learning_tpu_torch import evaluate as cli

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", SUP_CFGS[name], "--logdir", logdir, "--opts",
         *smoke_opts(["RNG_SEED", str(SEED), *opts])])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    return cfg


def step_with_peak(trainer, batch, it):
    """(ms, peak GiB above what was held, loss) of one warm step."""
    dev = trainer.device_batch(batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss = float(trainer.train_step(batch, dev, 9, it, 1e-4))
    torch.cuda.synchronize()
    return ((time.time() - t0) * 1e3,
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30, loss)


def eval_chunks(cfg, lens):
    """Chunks the eval sweep runs over videos of these lengths."""
    fpb = cfg.EVAL.FRAMES_PER_BATCH
    return sum(-(-n // fpb) for n in lens)


def tcc_transformer_path(data_root, card, lens):
    """tcc_transformer_config through `python -m ...train`'s function: one
    epoch and a checkpoint, then `--continue_train` for a second, each with
    its val epoch and evaluation; #1 and #3 must launch exactly once an
    encoder layer for each step, val batch and eval chunk (#3 for each
    step). Then warm steps (exact launches again) and a profiled step.
    Returns its launches."""
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    logdir = os.path.join(WORK, "tcc_transformer_logs")

    def argv(epochs, *flags):
        return ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                SUP_CFGS["tcc_transformer_config"], "--device", "cuda", *flags,
                "--opts", *smoke_opts(["TRAIN.MAX_EPOCHS", str(epochs),
                                       "LOGGING.REPORT_INTERVAL", "3", "RNG_SEED",
                                       str(SEED), *TCC_OPTS])]

    _reset_launches()
    EmbeddingCheck.seen.clear()
    t0 = time.time()
    first = train_main(argv(1))
    trainer = train_main(argv(2, "--continue_train", "--tempcfg"))
    torch.cuda.synchronize()
    launches = _read_launches()
    cfg = trainer.cfg
    layers = cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    steps = len(first.train_loader) + len(trainer.train_loader)
    per_run = len(trainer.val_loader) + eval_chunks(cfg, lens)
    want = {"flash_attn_fwd": layers * (steps + 2 * per_run),
            "flash_attn_bwd": layers * steps}
    got = {k: launches[k] for k in want}
    log(f"tcc_transformer_config (TCC {cfg.TCC.LOSS_TYPE}, {cfg.TCC.SIMILARITY_TYPE} "
        f"similarity; {cfg.TRAIN.BATCH_SIZE} clips x {cfg.TRAIN.NUM_FRAMES} frames a "
        f"step, supervised augmentation): two CLI runs (epoch 0, then epoch 1 "
        f"resumed at {trainer.start_epoch}) in {time.time() - t0:.2f} s; launches "
        f"{json.dumps(got)} (expected {json.dumps(want)}: {layers} encoder layers x "
        f"{steps} steps, 2 x {len(trainer.val_loader)} val batches, 2 x "
        f"{eval_chunks(cfg, lens)} eval chunks)")
    if trainer.start_epoch != 1 or got != want:
        raise AssertionError("tcc_transformer_config's runs did not resume or "
                             "launched #1 / #3 the wrong number of times")
    if len(EmbeddingCheck.seen) != 4:
        raise AssertionError("the embedding check did not run after each run")
    _reset_launches()
    batch, step_ms, losses = warm_steps(trainer, 5)
    warm = _read_launches()
    clips = batch["videos"].shape[0]
    log(f"tcc_transformer train step (warm, USE_AMP bf16 backbone, {clips} clips x "
        f"{cfg.TRAIN.NUM_FRAMES} frames of 256x256 uint8 -> 224 px, H2D + supervised "
        f"augment + forward + TCC + backward + Adam): {step_ms:.1f} ms/step, "
        f"{clips / step_ms * 1e3:.2f} clips/s on {card}; losses {losses}; "
        f"#1 {warm['flash_attn_fwd']}, #3 {warm['flash_attn_bwd']} launches in 6 steps")
    if warm["flash_attn_fwd"] != 6 * layers or warm["flash_attn_bwd"] != 6 * layers:
        raise AssertionError("the warm TCC steps launched #1 / #3 the wrong number "
                             "of times")
    _add(launches, warm)
    profile_train_step(trainer, batch, "TCC transformer", "tcc_train_step_trace.json",
                       {"flash_fwd": "flash_attn_fwd", "flash_bwd": "flash_attn_bwd"})
    return launches


def tcc_conv_path(data_root, card):
    """tcc_config: the conv embedder over conv1-layer3 trained with the rest
    (train_all), one warm step with its peak memory; then the
    evaluation CLI from its checkpoint (NUM_CONTEXTS 2, the default four
    tasks) and the warm sweep's frames/s. No attention kernel launches.
    Returns its launches."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import get_embeddings_dataset
    from video_rep_learning_tpu_torch.models import (build_model, load_checkpoint,
                                                     save_checkpoint)
    from video_rep_learning_tpu_torch.train import Trainer

    logdir = os.path.join(WORK, "tcc_conv_logs")
    _reset_launches()
    cfg = sup_cfg("tcc_config", data_root, logdir, TCC_OPTS)
    torch.manual_seed(SEED)
    trainer = Trainer(cfg, no_eval=True, device="cuda")
    batch = next(iter(trainer.train_loader))
    step_with_peak(trainer, batch, 0)
    ms, peak, loss = step_with_peak(trainer, batch, 1)
    B, n = batch["videos"].shape[:2]
    log(f"tcc_config train step (warm, conv embedder, train_all: {B} clips x "
        f"{cfg.TRAIN.NUM_FRAMES} steps x {cfg.DATA.NUM_CONTEXTS} contexts = {B * n} "
        f"frames through conv1-layer3 with grad under bf16 autocast, two Conv3d of "
        f"{cfg.MODEL.EMBEDDER_MODEL.CONV_LAYERS[0][0] * cfg.MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR}"
        f" channels): {ms:.1f} ms, {B / ms * 1e3:.2f} clips/s, peak device memory "
        f"{peak:.2f} GiB above the {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"held, on {card}; loss {loss:.6f}")
    if not np.isfinite(loss):
        raise AssertionError("tcc_config's step gave a non-finite loss")
    save_checkpoint(trainer.model, logdir, 0)
    del trainer
    torch.cuda.empty_cache()
    EmbeddingCheck.seen.clear()
    metrics = cli.main(["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                        SUP_CFGS["tcc_config"], "--device", "cuda", "--opts",
                        *smoke_opts(tasks=DEFAULT_TASKS)])
    log(f"tcc_config eval (NUM_CONTEXTS {cfg.DATA.NUM_CONTEXTS}, CONTEXT_STRIDE "
        f"{cfg.DATA.CONTEXT_STRIDE}): metrics {json.dumps(metrics)}; embeddings "
        f"{EmbeddingCheck.seen}")
    if (len(EmbeddingCheck.seen) != 2 or not set(DEFAULT_TASKS) <= set(metrics)
            or not all(np.isfinite(v) for m in metrics.values() for v in m.values())):
        raise AssertionError("tcc_config's evaluation failed")
    model = build_model(cfg, "cuda")
    load_checkpoint(model, logdir)
    loader = cli.build_eval_loaders(cfg, "val")[0]
    get_embeddings_dataset(cfg, model, loader, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = get_embeddings_dataset(cfg, model, loader, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    frames = sum(out["seq_lens"])
    log(f"tcc_config embedding sweep (val, warm, NUM_CONTEXTS 2: {2 * frames} "
        f"frames of 256x256 uint8 -> 224 px for {frames} embeddings): "
        f"{frames / dt:.1f} embedded frames/s in {dt:.3f} s on {card}")
    launches = _read_launches()
    if launches["flash_attn_fwd"] or launches["flash_attn_bwd"]:
        raise AssertionError("the conv embedder's path launched attention")
    return launches


def one_step_path(name, data_root, card, opts=(), val=False):
    """One warm step of `name`'s trainer (and with `val` its val epoch);
    returns (launches, val loss or None)."""
    from video_rep_learning_tpu_torch.train import Trainer

    _reset_launches()
    cfg = sup_cfg(name, data_root, os.path.join(WORK, name + "_logs"), opts)
    torch.manual_seed(SEED)
    trainer = Trainer(cfg, no_eval=not val, device="cuda")
    batch, step_ms, losses = warm_steps(trainer, 1)
    B = batch["videos"].shape[0]
    log(f"{name} train step (warm, {cfg.TRAINING_ALGO}, "
        f"{cfg.MODEL.EMBEDDER_TYPE} embedder, {tuple(batch['videos'].shape)} uint8 "
        f"-> 224 px): {step_ms:.1f} ms/step, {B / step_ms * 1e3:.2f} clips/s on "
        f"{card}; losses {losses}")
    acc = trainer.val_one_epoch(0)["loss"] if val else None
    launches = _read_launches()
    del trainer
    torch.cuda.empty_cache()
    return launches, acc


def phase_supervised(data_root, card, lens):
    """15: the supervised paths at full width (see the module docstring);
    returns each path's launches."""
    paths = {"tcc_transformer": tcc_transformer_path(data_root, card, lens)}
    torch.cuda.empty_cache()
    paths["tcc_config"] = tcc_conv_path(data_root, card)
    torch.cuda.empty_cache()
    paths["tcn_config"], _ = one_step_path("tcn_config", data_root, card)
    cls, acc = one_step_path("classification_transformer_config", data_root, card,
                             val=True)
    log(f"classification_transformer_config val epoch: masked accuracy {acc:.4f}; "
        f"#1 {cls['flash_attn_fwd']}, #3 {cls['flash_attn_bwd']} launches")
    if not 0.0 <= acc <= 1.0 or not cls["flash_attn_fwd"] or not cls["flash_attn_bwd"]:
        raise AssertionError("classification's step or val epoch failed")
    paths["classification"] = cls
    paths["scl_config"], _ = one_step_path("scl_config", data_root, card)
    log(f"scl_config (SCL over the conv embedder): crop_photometric "
        f"{paths['scl_config']['crop_photometric']} launches")
    if paths["scl_config"]["crop_photometric"] <= 0:
        raise AssertionError("scl_config's steps never launched crop_photometric")
    if any(p["flash_attn_fwd"] for k, p in paths.items()
           if k in ("tcn_config", "scl_config")):
        raise AssertionError("a conv embedder's path launched attention")

    # one fp32 TCC step, card vs CPU, the whole supervised chain on
    cap = {}
    _reset_launches()
    cfg, B, _, out = fp32_step_card_and_cpu(
        SUP_CFGS["tcc_transformer_config"], data_root, TCC_STEP_FRAMES, SEED + 3,
        capture_layer4(cap), opts=("AUGMENTATION.HUE", "True",
                                   "AUGMENTATION.SATURATION", "True"))
    step = _read_launches()
    ok, groups = check_step(
        f"one fp32 TCC training step (tcc_transformer_config, {B} clips x "
        f"{TCC_STEP_FRAMES} frames that differ, every supervised jitter on)", out,
        GRAD_GROUPS, held_elsewhere=("layer4",))
    ok &= layer4_card_vs_cpu(cfg, cap, out, groups["layer4"])
    layers = cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    ok &= step["flash_attn_fwd"] == layers and step["flash_attn_bwd"] == layers
    log(f"card vs CPU TCC step: #1 {step['flash_attn_fwd']}, #3 "
        f"{step['flash_attn_bwd']} launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's fp32 TCC step disagrees with the CPU's")
    paths["fp32 TCC step"] = step
    return paths


# Phase 16: late fusion over a ViT, the FineGym harness, mid-epoch resume
LATE_CFGS = {k: os.path.join(REPO, "configs_mvf", f"ablate_dinoB8_{k}.yml")
             for k in ("avg", "cls", "max")}
# the ablations train on 13 Penn Action classes; the smoke swaps in the
# synthetic Pouring set, as every other phase does
LATE_DATA = ("DATASETS", "[pouring]", "PATH_TO_DATASET", "pouring")
FG_CFG_FILE = os.path.join(REPO, "configs_mvf", "fg99_mvf.yml")
FG_SPLITS = {"train": 20, "val": 6}  # videos; fraction 0.1 still makes a batch
MID_SAVE_N, MID_STEPS = 2, 6


def vit_launches(frames, chunk=40, depth=12):
    """The fully frozen ViT's launches over `frames` frames in `chunk`-frame
    chunks: a final norm, and 12 half-blocks each of one #5 (one #4, two
    ln_gemm) and one #6 a chunk."""
    chunks = -(-frames // chunk)
    return {"layernorm": chunks, "vit_attention_block": depth * chunks,
            "packed_attn": depth * chunks, "ln_gemm": 3 * depth * chunks}


def late_cfg(kind, logdir, opts=()):
    from video_rep_learning_tpu_torch import evaluate as cli

    return cli.load_config(cli.parse_cli(
        ["--cfg_file", LATE_CFGS[kind], "--logdir", logdir, "--opts",
         *smoke_opts(["RNG_SEED", str(SEED), *LATE_DATA, *opts])])[0])


def late_sweep(cfg, model, what, card):
    """The warm eval sweep of the val split: frames/s."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import get_embeddings_dataset

    loader = cli.build_eval_loaders(cfg, "val")[0]
    get_embeddings_dataset(cfg, model, loader, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = get_embeddings_dataset(cfg, model, loader, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    frames = sum(out["seq_lens"])
    embs = np.concatenate(out["embs"])
    if embs.shape != (frames, 128) or not np.isfinite(embs).all():
        raise AssertionError(f"{what}: bad sweep embeddings {embs.shape}")
    log(f"{what} embedding sweep (val, warm, bf16 ViT-B/8, {frames} frames of "
        f"256x256 uint8 -> 224 px): {frames / dt:.1f} frames/s in {dt:.3f} s on {card}")
    return frames / dt


def late_avg_cli(data_root, card, lens):
    """ablate_dinoB8_avg (late-spatial, SMART_FEATS 3,7,11 -> 2304 channels,
    average pooled) through the train CLI for an epoch with a mid-epoch
    checkpoint every MID_SAVE_N steps, then `--continue_train` for a second;
    #1 and #3 once an encoder layer for each step, val batch and eval chunk
    (#3 a step), the ViT's launches by its blocks, every `backbone.*`
    bit-identical. Returns (launches, trainer)."""
    from video_rep_learning_tpu_torch.models import build_model
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    logdir = os.path.join(WORK, "late_avg_logs")

    def argv(epochs, *flags):
        return ["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                LATE_CFGS["avg"], "--device", "cuda", *flags, "--opts", *smoke_opts(
                    ["TRAIN.MAX_EPOCHS", str(epochs), "LOGGING.REPORT_INTERVAL", "3",
                     "RNG_SEED", str(SEED), "CHECKPOINT.SAVE_EVERY_N_ITERS",
                     str(MID_SAVE_N), *LATE_DATA])]

    EmbeddingCheck.seen = []
    _reset_launches()
    t0 = time.time()
    first = train_main(argv(1))
    ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
    if ckpts != ["checkpoint_epoch_00000.pth"]:
        raise AssertionError(f"late avg: the epoch save left {ckpts}")
    trainer = train_main(argv(2, "--continue_train", "--tempcfg"))
    torch.cuda.synchronize()
    launches = _read_launches()
    cfg = trainer.cfg
    layers = cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    steps = len(first.train_loader) + len(trainer.train_loader)
    per_run = len(trainer.val_loader) + eval_chunks(cfg, lens)
    want = {"flash_attn_fwd": layers * (steps + 2 * per_run),
            "flash_attn_bwd": layers * steps, "crop_photometric": steps + 2 * len(
                trainer.val_loader)}
    got = {k: launches[k] for k in want}
    log(f"late avg (configs_mvf/ablate_dinoB8_avg.yml: ViT-B/8 fully frozen, taps "
        f"{trainer.model.spec.tap_blocks} -> {trainer.model.spec.out_channel} channels, "
        f"{cfg.MODEL.EMBEDDER_MODEL.FLATTEN_METHOD}, {cfg.TRAIN.NUM_FRAMES} frames a "
        f"view): two CLI runs (epoch 0 with a mid checkpoint every {MID_SAVE_N} steps, "
        f"epoch 1 resumed at {trainer.start_epoch}) in {time.time() - t0:.2f} s; "
        f"checkpoints {sorted(os.listdir(os.path.join(logdir, 'checkpoints')))}; "
        f"launches {json.dumps(launches)}; #1 / #3 / #12 {json.dumps(got)} (expected "
        f"{json.dumps(want)})")
    _check_vit_blocks("late avg CLI", launches)
    if trainer.start_epoch != 1 or got != want or len(EmbeddingCheck.seen) != 4:
        raise AssertionError("the late avg runs did not resume, launched #1 / #3 / "
                             "#12 the wrong number of times, or skipped the check")
    if sorted(os.listdir(os.path.join(logdir, "checkpoints"))) != [
            "checkpoint_epoch_00000.pth", "checkpoint_epoch_00001.pth"]:
        raise AssertionError("late avg: mid checkpoints outlived the epoch save")
    torch.manual_seed(cfg.RNG_SEED)
    init = build_model(cfg, "cpu").state_dict()
    trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    moved = vit = vit_moved = 0
    for n, v in trainer.model.state_dict().items():
        same = torch.equal(v.cpu(), init[n])
        if n in trainable:
            moved += not same
        elif n.startswith("backbone."):
            vit += 1
            vit_moved += not same
    log(f"late avg: {moved} of {len(trainable)} trainable tensors moved, {vit_moved} "
        f"of {vit} backbone.* tensors moved")
    if moved != len(trainable) or vit_moved or not vit:
        raise AssertionError("the wrong late avg parameters moved")
    return launches, trainer


def late_step(kind, data_root, card):
    """Warm steps of ablate_dinoB8_{kind} with their exact launches: the ViT
    by its chunks, #1 and #3 once an encoder layer a step, #12 once; then a
    profiled step. Returns (launches, trainer, ms a step)."""
    from video_rep_learning_tpu_torch.train import Trainer

    cfg = late_cfg(kind, os.path.join(WORK, f"late_{kind}_logs"))
    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    torch.manual_seed(SEED)
    trainer = Trainer(cfg, no_eval=True, device="cuda")
    _reset_launches()
    batch, step_ms, losses = warm_steps(trainer, 2)
    launches = _read_launches()
    clips, views, T = batch["videos"].shape[:3]
    layers = cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    want = {k: 3 * n for k, n in vit_launches(views * T).items()}
    want.update(flash_attn_fwd=3 * layers, flash_attn_bwd=3 * layers,
                crop_photometric=3)
    got = {k: launches[k] for k in want}
    spec = trainer.model.spec
    log(f"late {kind} train step (warm, LATE_TYPE {spec.late_type}, taps "
        f"{spec.tap_blocks}, {spec.out_channel} channels, {spec.flatten_method}; "
        f"{clips} clip x {views} views x {T} frames of 256x256 uint8 -> 224 px, bf16 "
        f"ViT-B/8 in {spec.frames_per_batch}-frame chunks, H2D + #12 + ViT + late "
        f"head + SCL + backward + Adam): {step_ms:.1f} ms/step, "
        f"{clips / step_ms * 1e3:.3f} clips/s on {card}; losses {losses}; launches "
        f"in 3 steps {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"late {kind}: launches {got}, expected {want}")
    profile_train_step(trainer, batch, f"late {kind}", f"late_{kind}_step_trace.json",
                       dict(OWN_KERNELS, flash_bwd_mma_kernel="flash_attn_bwd",
                            crop_strip_kernel="crop_photometric"))
    return launches, trainer, step_ms


def late_cls_layout(trainer):
    """A late-cls checkpoint holds the ViT under `backbone.*` (the
    reference's bare timm model) and reloads strictly into a fresh model."""
    from video_rep_learning_tpu_torch.models import (build_model, load_checkpoint,
                                                     save_checkpoint)

    logdir = os.path.join(WORK, "late_cls_logs")
    path = save_checkpoint(trainer.model, logdir, 0)
    state = torch.load(path, map_location="cpu", weights_only=False)["model_state"]
    vit = [k for k in state if k.startswith("backbone.")]
    wrapped = [k for k in vit if k.startswith("backbone.model.")]
    fresh = build_model(trainer.cfg, "cuda")
    load_checkpoint(fresh, logdir)
    want = trainer.model.state_dict()
    same = all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
    log(f"late cls checkpoint: {len(vit)} ViT tensors under backbone.* "
        f"({len(wrapped)} under backbone.model.*), reloaded strictly, "
        f"{'bit-identical' if same else 'DIFFERS'}")
    if not vit or wrapped or not same:
        raise AssertionError("the late-cls checkpoint's layout or reload is wrong")
    return logdir


def phase_late(data_root, card, lens):
    """16a: the late-fusion ViT ablations (see the module docstring).
    Returns ({path: launches}, numbers)."""
    from video_rep_learning_tpu_torch.evaluation import TASK_REGISTRY

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    paths, nums = {}, {}
    paths["late avg CLI"], avg = late_avg_cli(data_root, card, lens)
    nums["avg_sweep_fps"] = late_sweep(avg.cfg, avg.model, "late avg", card)
    avg_logdir = avg.cfg.LOGDIR
    del avg
    torch.cuda.empty_cache()
    for kind in ("cls", "max"):
        paths[f"late {kind} steps"], trainer, nums[f"{kind}_step_ms"] = late_step(
            kind, data_root, card)
        if kind == "cls":
            cls_logdir = late_cls_layout(trainer)
            trainer.model.eval()
            nums["cls_sweep_fps"] = late_sweep(trainer.cfg, trainer.model, "late cls",
                                               card)
        del trainer
        torch.cuda.empty_cache()
    phase_card_vs_cpu(data_root, cls_logdir, LATE_CFGS["cls"], MVF_CARD_VS_CPU,
                      "late cls ViT", LATE_DATA)
    phase_card_vs_cpu(data_root, avg_logdir, LATE_CFGS["avg"], MVF_CARD_VS_CPU,
                      "late-spatial avg ViT", LATE_DATA)
    return paths, nums


def make_gym99_set():
    """A synthetic set in the gym99 layout (`gym99_train_v1.0.pkl`,
    `gym99_val.pkl`, npy videos): FG_SPLITS videos of 60-150 frames at 256
    px, labels in 0..98 with a tenth of the frames at -1."""
    from video_rep_learning_tpu_torch.data.decode import encode_video

    root = os.path.join(WORK, "data", "finegym")
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    rng = np.random.RandomState(SEED)
    lens = {}
    for split, n in FG_SPLITS.items():
        entries = []
        for i in range(n):
            seq_len = int(rng.randint(60, 151))
            base = rng.randint(0, 256, (1, 1, 1, 3))
            frames = np.clip(base + rng.randint(-40, 41, (seq_len, 256, 256, 3)), 0,
                             255).astype(np.uint8)
            rel = os.path.join("videos", f"{split}_{i}.npy")
            encode_video(os.path.join(root, rel), frames)
            labels = rng.randint(0, 99, seq_len).astype(np.int64)
            labels[rng.rand(seq_len) < 0.1] = -1
            entries.append({"id": i, "name": f"gym/{split}_{i}", "video_file": rel,
                            "frame_label": labels, "seq_len": seq_len})
        with open(os.path.join(root, "gym99_train_v1.0.pkl" if split == "train"
                               else "gym99_val.pkl"), "wb") as f:
            pickle.dump(entries, f)
        lens[split] = [e["seq_len"] for e in entries]
    log(f"synthetic gym99 set: {FG_SPLITS} videos at 256x256, lengths {lens}")
    return os.path.dirname(root), lens


@contextmanager
def timing(module, name, spans):
    """Time every call of `module.name` (synchronised), appending seconds to
    `spans`; restored after the block."""
    real = getattr(module, name)

    def timed_call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append(time.time() - t0)
        return out

    setattr(module, name, timed_call)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_finegym(card):
    """16b: fg99_mvf.yml at full width over a synthetic gym99 set: one epoch
    through the train CLI (its evaluation runs the harness), then the
    harness through `python -m video_rep_learning_tpu_torch.evaluate_finegym`'s
    function at the config's own probe settings. Returns (launches,
    numbers)."""
    from video_rep_learning_tpu_torch.evaluate_finegym import main as fg_main
    from video_rep_learning_tpu_torch.evaluation import finegym
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    data_root, lens = make_gym99_set()
    logdir = os.path.join(WORK, "fg99_logs")
    opts = ["DATA.NUM_WORKERS", "4", "RNG_SEED", str(SEED)]
    _reset_launches()
    t0 = time.time()
    trainer = train_main(["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                          FG_CFG_FILE, "--device", "cuda", "--opts",
                          "TRAIN.MAX_EPOCHS", "1", *opts])
    torch.cuda.synchronize()
    launches = _read_launches()
    cfg = trainer.cfg
    steps = len(trainer.train_loader)
    log(f"fg99_mvf train CLI (ViT-B/8 fully frozen, taps "
        f"{trainer.model.spec.tap_blocks}, {cfg.MODEL.EMBEDDER_MODEL.SMART_TOKENS} "
        f"LSTP tokens, embedding {cfg.MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE}; {steps} "
        f"steps of 2 views x {cfg.TRAIN.NUM_FRAMES} frames, val, the harness) in "
        f"{time.time() - t0:.2f} s; launches {json.dumps(launches)}")
    _check_vit_blocks("fg99 train CLI", launches)
    if launches["flash_attn_bwd"] != cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS * steps:
        raise AssertionError("fg99: #3 did not launch once an encoder layer a step")
    del trainer
    torch.cuda.empty_cache()

    spans = {"dump": [], "probe": []}
    _reset_launches()
    with timing(finegym, "dump_embeddings_dataset", spans["dump"]), \
            timing(finegym, "train_linear_probe", spans["probe"]):
        accs = fg_main(["--workdir", data_root, "--logdir", logdir, "--cfg_file",
                        FG_CFG_FILE, "--device", "cuda", "--opts", *opts])
    eval_launches = _read_launches()
    _add(launches, eval_launches)
    frames = {s: sum(n) for s, n in lens.items()}
    ok = sorted(accs) == sorted(cfg.EVAL.CLASSIFICATION_FRACTIONS) and all(
        np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs.values())
    for split, n in FG_SPLITS.items():
        d = os.path.join(logdir, f"finegym_eval_{split}set")
        files = sorted(os.listdir(d))
        widths = set()
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                rec = pickle.load(f)
            widths.add(rec["embs"].shape[1])
            ok &= bool(np.isfinite(rec["embs"]).all()) and bool((rec["labels"] >= 0).all())
        ok &= len(files) == n and widths == {256}
        log(f"fg99 harness {split}: {len(files)} pickles, embs width {sorted(widths)}")
    fps = {s: frames[s] / t for s, t in zip(FG_SPLITS, spans["dump"])}
    log(f"fg99 harness (evaluate_finegym, EVAL.FRAMES_PER_BATCH "
        f"{cfg.EVAL.FRAMES_PER_BATCH}, probe LR {cfg.EVAL.CLASSIFICATION_LR} over "
        f"{cfg.EVAL.CLASSIFICATION_EPOCHS} epochs): accuracies {json.dumps(accs)}; "
        f"sweep {json.dumps({s: round(v, 1) for s, v in fps.items()})} frames/s "
        f"({json.dumps(frames)} frames in {[round(t, 3) for t in spans['dump']]} s); "
        f"probe {[round(t, 3) for t in spans['probe']]} s a fraction; launches "
        f"{json.dumps(eval_launches)} on {card}")
    _check_vit_blocks("fg99 harness", eval_launches)
    if not ok or eval_launches["flash_attn_fwd"] <= 0:
        raise AssertionError("the FineGym harness failed its checks")
    return launches, {"sweep_fps": fps, "probe_s": spans["probe"], "accs": accs}


class _Preempted(Exception):
    pass


def phase_mid_resume(data_root):
    """16c: pouring_mvf.yml (fully frozen ViT-B/8, VRL_FUSED_SCL=1) for one
    epoch of MID_STEPS steps with a mid checkpoint every MID_SAVE_N steps,
    uninterrupted; then again, stopped after the second mid save and resumed
    by a new trainer. Every trainable tensor, buffer and optimizer moment
    must be bit-identical. Returns the launches of the three runs."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.train import Trainer
    from video_rep_learning_tpu_torch.train import checkpoint as ckpt
    from video_rep_learning_tpu_torch.train import trainer as trainer_mod

    seed_path, _ = seeded_mvf_checkpoint(cli.load_config(cli.parse_cli(
        ["--cfg_file", MVF_CFG_FILE])[0]))

    def make(logdir):
        cfg = cli.load_config(cli.parse_cli(
            ["--cfg_file", MVF_CFG_FILE, "--logdir", logdir, "--opts", *smoke_opts(
                ["RNG_SEED", str(SEED), "TRAIN.MAX_EPOCHS", "1",
                 "CHECKPOINT.SAVE_EVERY_N_ITERS", str(MID_SAVE_N),
                 "MODEL.PRETRAINED_CHECKPOINT", seed_path])])[0])
        cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
        shutil.rmtree(logdir, ignore_errors=True)
        trainer = Trainer(cfg, no_eval=True, device="cuda")
        trainer.init_state()
        return trainer

    real_save = ckpt.save_mid_checkpoint
    cut_dir = os.path.join(WORK, "mid_cut_logs")

    def save_or_stop(logdir, model, optimizer, epoch, next_iter, cfg=None):
        path = real_save(logdir, model, optimizer, epoch, next_iter, cfg)
        if logdir == cut_dir and next_iter == 2 * MID_SAVE_N:
            raise _Preempted
        return path

    _reset_launches()
    trainer_mod.save_mid_checkpoint = save_or_stop
    try:
        with env_vars(VRL_FUSED_SCL="1"):
            once = make(os.path.join(WORK, "mid_once_logs"))
            once.fit()
            cut = make(cut_dir)
            try:
                cut.fit()
                raise AssertionError("the preempted run was not stopped")
            except _Preempted:
                pass
            resumed = Trainer(cut.cfg, no_eval=True, device="cuda")
            resumed.init_state()
            start = (resumed.start_epoch, resumed.start_iter)
            resumed.fit()
    finally:
        trainer_mod.save_mid_checkpoint = real_save
    torch.cuda.synchronize()
    launches = _read_launches()
    want, got = once.model.state_dict(), resumed.model.state_dict()
    differ = [k for k, v in got.items() if not torch.equal(v, want[k])]
    differ += [f"optimizer.{w}.{n}" for w in ("mu", "nu")
               for n, a, b in zip(once.optimizer.names, getattr(once.optimizer, w),
                                  getattr(resumed.optimizer, w))
               if not torch.equal(a, b)]
    steps = len(once.train_loader)
    trainable = sum(p.requires_grad for p in once.model.parameters())
    log(f"mid-epoch resume (pouring_mvf, VRL_FUSED_SCL=1, {steps} steps, a mid "
        f"checkpoint every {MID_SAVE_N}): stopped after step {2 * MID_SAVE_N}, "
        f"resumed at (epoch, iter) {start}; optimizer steps {once.optimizer.count} "
        f"vs {resumed.optimizer.count}; {len(got)} tensors ({trainable} trainable) "
        f"and {2 * len(once.optimizer.names)} optimizer moments: "
        f"{'bit-identical' if not differ else 'DIFFER: ' + ', '.join(differ[:12])}; "
        f"launches {json.dumps(launches)}")
    if (steps != MID_STEPS or start != (0, 2 * MID_SAVE_N) or differ
            or resumed.optimizer.count != once.optimizer.count):
        raise AssertionError("the resumed run is not the uninterrupted one")
    return launches


# ---------------------------------------------------------------------------
# phase 17: data parallelism (one process per card; two ranks share the card)
# ---------------------------------------------------------------------------

DDP_WARM_STEPS = 3  # timed warm steps a rank and config
DDP_TIMEOUT_S = 600  # a collective waiting on a dead peer fails after this
DDP_FP32_FRAMES = 16  # a view, for the two-rank fp32 step card vs CPU


def phase_ddp_world1(data_root, card):
    """17a: pouring_mvf.yml through `python -m video_rep_learning_tpu_torch.train`'s
    function under VRL_FUSED_SCL=1 for one epoch, without a process group and
    as rank 0 of a world of 1 over NCCL (DDP, the synced BatchNorm): equal
    launches of every kernel and bit-identical weights, BN statistics and
    optimizer moments. Then warm steps of each in turns (none, NCCL, NCCL,
    none). Returns the NCCL run's launches and the numbers."""
    from torch.nn.parallel import DistributedDataParallel

    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import TASK_REGISTRY
    from video_rep_learning_tpu_torch.parallel import process_group
    from video_rep_learning_tpu_torch.tools.ddp_cards import free_port
    from video_rep_learning_tpu_torch.train import Trainer
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    TASK_REGISTRY["embedding_check"] = EmbeddingCheck
    opts = smoke_opts(["TRAIN.MAX_EPOCHS", "1", "RNG_SEED", str(SEED)],
                      tasks=("kendalls_tau",))
    runs = {}
    with env_vars(VRL_FUSED_SCL="1"):
        for name in ("none", "nccl"):
            logdir = os.path.join(WORK, f"ddp_world1_{name}_logs")
            shutil.rmtree(logdir, ignore_errors=True)
            flags = [] if name == "none" else [
                "--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", "1",
                "--process_id", "0"]
            _reset_launches()
            t0 = time.time()
            trainer = train_main(["--workdir", data_root, "--logdir", logdir,
                                  "--cfg_file", MVF_CFG_FILE, "--device", "cuda", *flags,
                                  "--opts", *opts])
            torch.cuda.synchronize()
            wrapped = isinstance(trainer.net, DistributedDataParallel)
            if wrapped != (name == "nccl") or torch.distributed.is_initialized():
                raise AssertionError(f"17a {name}: DDP {wrapped}, group left "
                                     f"{torch.distributed.is_initialized()}")
            runs[name] = (_read_launches(), trainer, time.time() - t0)
        (l0, t_none, s0), (l1, t_nccl, s1) = runs["none"], runs["nccl"]
        a, b = t_none.model.state_dict(), t_nccl.model.state_dict()
        differ = [k for k, v in a.items() if not torch.equal(v, b[k])]
        differ += [f"optimizer.{w}.{n}" for w in ("mu", "nu")
                   for n, x, y in zip(t_none.optimizer.names, getattr(t_none.optimizer, w),
                                      getattr(t_nccl.optimizer, w)) if not torch.equal(x, y)]
        steps = len(t_nccl.train_loader)
        log(f"17a world-1 NCCL (pouring_mvf, VRL_FUSED_SCL=1, {steps} steps, val, "
            f"evaluation): {s1:.2f} s vs {s0:.2f} s without a group; launches "
            f"{'equal' if l0 == l1 else 'DIFFER'} {json.dumps(l1)}; {len(a)} tensors and "
            f"{2 * len(t_none.optimizer.names)} optimizer moments "
            + ("bit-identical" if not differ else "DIFFER: " + ", ".join(differ[:12])))
        if l0 != l1 or differ or l1["scl_grad"] != steps:
            raise AssertionError("the world-1 NCCL run is not the run without a group")
        del runs, t_none, t_nccl, trainer
        torch.cuda.empty_cache()
        cfg = cli.load_config(cli.parse_cli(["--cfg_file", MVF_CFG_FILE, "--opts", *opts])[0])
        cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
        step_ms = {"none": [], "nccl": []}
        for name in ("none", "nccl", "nccl", "none"):
            with process_group(None if name == "none" else f"127.0.0.1:{free_port()}",
                               1, 0, "cuda") as device:
                trainer = Trainer(cfg, no_eval=True, device=device)
                step_ms[name].append(warm_steps(trainer, DDP_WARM_STEPS)[1])
                del trainer
            torch.cuda.empty_cache()
    log(f"17a warm ms/step, pouring_mvf, VRL_FUSED_SCL=1, in turns: without a group "
        f"{step_ms['none']}, world-1 NCCL (DDP) {step_ms['nccl']} on {card}")
    return l1, {"step_ms": step_ms, "cli_s": {"none": s0, "nccl": s1}}


def _ddp_cfg(cfg_file, data_root, opts=()):
    from video_rep_learning_tpu_torch import evaluate as cli

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", cfg_file, "--opts", *smoke_opts(["RNG_SEED", str(SEED), *opts])])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    return cfg


def _ranks_agree(what, value):
    """Every rank's `value` (gathered), which must be one."""
    from video_rep_learning_tpu_torch.parallel import all_gather_object

    values = all_gather_object(value)
    if any(v != values[0] for v in values):
        raise AssertionError(f"{what}: the ranks disagree: {values}")
    return values


def ddp_steps(what, cfg_file, data_root, want, opts=()):
    """DDP_WARM_STEPS timed warm steps on this rank's first batch after one
    untimed: exact launches (`want`, a step's), the state bit-identical
    across the ranks after every step. Returns (ms/step, losses)."""
    from video_rep_learning_tpu_torch.parallel import world
    from video_rep_learning_tpu_torch.tools.ddp_cards import state_digest
    from video_rep_learning_tpu_torch.train import Trainer

    trainer = Trainer(_ddp_cfg(cfg_file, data_root, opts), no_eval=True, device="cuda")
    trainer.train_loader.set_epoch(0)
    batch = next(iter(trainer.train_loader))
    trainer.train_step(batch, trainer.device_batch(batch), 9, 0, 1e-4)
    _ranks_agree(f"{what} after the untimed step", state_digest(trainer.model))
    _reset_launches()
    spent, losses = 0.0, []
    for it in range(DDP_WARM_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(trainer.train_step(batch, trainer.device_batch(batch), 9,
                                               it + 1, 1e-4)))
        spent += time.time() - t0
        _ranks_agree(f"{what} after step {it + 1}", state_digest(trainer.model))
    launches = _read_launches()
    got = {k: launches[k] for k in want}
    want = {k: v * DDP_WARM_STEPS for k, v in want.items()}
    step_ms = spent / DDP_WARM_STEPS * 1e3
    size, rank = world()
    log(f"17b rank {rank} of {size}, {what}: {step_ms:.1f} ms/step over "
        f"{DDP_WARM_STEPS} warm steps ({batch['videos'].shape[0]} clip a rank); "
        f"losses {losses}; launches {json.dumps(got)} (expected {json.dumps(want)}); "
        f"ranks bit-identical after every step")
    if got != want or not all(np.isfinite(losses)):
        raise AssertionError(f"17b {what}: wrong launches or a non-finite loss")
    del trainer
    torch.cuda.empty_cache()
    return step_ms, losses


def ddp_fp32_step(data_root):
    """One fp32 step of scl_transformer_config (USE_AMP off, TF32 off,
    dropout off, DDP_FP32_FRAMES frames a view of frames that differ, jitter
    and blur on) at two ranks, on the card and on the CPU over the same
    group: the same weights, batch and sampled augmentation (the rank's rows
    of the global draw). Frames, the ranks' mean loss and the averaged head
    gradients held card vs CPU on STEP_TOL (layer4 logged: phase 6 holds it
    in fp64)."""
    from video_rep_learning_tpu_torch.ops.augment import (AugmentParams,
                                                          sample_ssl_batch,
                                                          ssl_batch_augment)
    from video_rep_learning_tpu_torch.parallel import all_reduce_sum, world
    from video_rep_learning_tpu_torch.train import Trainer

    size, rank = world()
    cfg = _ddp_cfg(CFG_FILE, data_root, ["USE_AMP", "False", "TRAIN.NUM_FRAMES",
                                         str(DDP_FP32_FRAMES),
                                         "MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE", "0.0"])
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(cfg, no_eval=True, build_loaders=dev == "cuda", device=dev)
        if dev == "cuda":
            trainer.train_loader.set_epoch(0)
            batch = next(iter(trainer.train_loader))
            videos = differing_frames(tuple(batch["videos"].shape), SEED + rank)
            B, V, _, H, W, _ = videos.shape
            aug = AugmentParams(image_size=cfg.IMAGE_SIZE)
            sampled = sample_ssl_batch(torch.Generator().manual_seed(SEED), B, V, H, W,
                                       batch["dims"], aug, skip=rank * B)
            sampled["fscal"][:, [0, 5]] = 1
        trainer.model.train()
        tb = {"videos": ssl_batch_augment(torch.as_tensor(videos).to(dev), sampled, aug)}
        for k in ("video_masks", "seq_lens", "chosen_steps"):
            tb[k] = torch.as_tensor(batch[k]).to(dev)
        loss = trainer.algo.compute_loss(trainer.net, tb)["loss"]
        loss.backward()
        out[dev] = (tb["videos"].float().cpu(), all_reduce_sum(loss.item()) / size,
                    _head_grads(trainer.model))
        del trainer
    ok, _ = check_step(f"17b rank {rank} of {size}: one fp32 step at two ranks (1 clip "
                       f"x 2 views x {DDP_FP32_FRAMES} frames a rank, full width, the "
                       f"ranks' mean loss, DDP-averaged gradients)", out, GRAD_GROUPS,
                       held_elsewhere=("layer4",))
    if not ok:
        raise AssertionError("17b: the card's two-rank fp32 step disagrees with the CPU's")
    return out["cuda"][1]


def ddp_tcc_step(data_root):
    """One tcc_transformer_config step at 1 clip a rank: the loss over the
    global pair list of the gathered embeddings (the branch for fewer than
    2 sequences a rank), the same on both ranks; #1 and #3 once an encoder
    layer; the ranks bit-identical after the step. Returns the loss."""
    from video_rep_learning_tpu_torch.algos import tcc
    from video_rep_learning_tpu_torch.parallel import world
    from video_rep_learning_tpu_torch.tools.ddp_cards import state_digest
    from video_rep_learning_tpu_torch.train import Trainer

    gathered = []
    real = tcc.all_gather_with_grad
    tcc.all_gather_with_grad = lambda t: gathered.append(t.shape) or real(t)
    try:
        trainer = Trainer(_ddp_cfg(SUP_CFGS["tcc_transformer_config"], data_root,
                                   ["TRAIN.BATCH_SIZE", "1"]), no_eval=True, device="cuda")
        trainer.train_loader.set_epoch(0)
        batch = next(iter(trainer.train_loader))
        _reset_launches()
        loss = float(trainer.train_step(batch, trainer.device_batch(batch), 0, 0, 1e-4))
        launches = _read_launches()
    finally:
        tcc.all_gather_with_grad = real
    layers = trainer.cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    losses = _ranks_agree("17b TCC loss", loss)
    _ranks_agree("17b TCC state after the step", state_digest(trainer.model))
    size, rank = world()
    log(f"17b rank {rank} of {size}, tcc_transformer (1 clip a rank, "
        f"{trainer.cfg.TRAIN.NUM_FRAMES} frames): loss {loss} on every rank "
        f"({losses}), gathered {[tuple(s) for s in gathered]}, #1 "
        f"{launches['flash_attn_fwd']}, #3 {launches['flash_attn_bwd']} launches")
    if (not np.isfinite(loss) or len(gathered) != 3 or launches["flash_attn_fwd"] != layers
            or launches["flash_attn_bwd"] != layers):
        raise AssertionError("17b: the TCC step did not take the global pair list")
    del trainer
    torch.cuda.empty_cache()
    return loss


def ddp_finegym(card):
    """17c: fg99_mvf's FineGym harness at two ranks on seeded weights over
    the synthetic gym99 set (made here if phase 16 did not): each rank dumps
    its half of the videos, the file lists are gathered, the probe runs at
    the config's settings on each rank's shard. Every video dumped once, one
    file list and one accuracy across the ranks. Returns the numbers."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.data import construct_dataloader
    from video_rep_learning_tpu_torch.evaluation import finegym
    from video_rep_learning_tpu_torch.models import build_model
    from video_rep_learning_tpu_torch.parallel import is_root_proc, synchronize, world

    root = os.path.join(WORK, "data")
    if is_root_proc() and not os.path.exists(os.path.join(root, "finegym", "gym99_val.pkl")):
        make_gym99_set()
    synchronize()
    logdir = os.path.join(WORK, "fg99_ddp_logs")
    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", FG_CFG_FILE, "--logdir", logdir, "--opts", "DATA.NUM_WORKERS",
         "4", "RNG_SEED", str(SEED)])[0])
    cfg.PATH_TO_DATASET = os.path.join(root, cfg.PATH_TO_DATASET)
    torch.manual_seed(SEED)
    model = build_model(cfg, "cuda")
    loaders = {s: construct_dataloader(cfg, s)[1][0] for s in FG_SPLITS}
    lists, spans = [], {"dump": [], "probe": []}
    real = finegym.train_linear_probe

    def probe(cfg_, train, val, *args, **kwargs):
        lists.append((list(train), list(val)))
        return real(cfg_, train, val, *args, **kwargs)

    finegym.train_linear_probe = probe
    try:
        with timing(finegym, "dump_embeddings_dataset", spans["dump"]), \
                timing(finegym, "train_linear_probe", spans["probe"]):
            accs = finegym.evaluate_loaders(cfg, model, loaders["train"], loaders["val"],
                                            0, None, "cuda")
    finally:
        finegym.train_linear_probe = real
    size, rank = world()
    _ranks_agree("17c accuracies", accs)
    _ranks_agree("17c gathered file lists", lists)
    ok = sorted(accs) == sorted(cfg.EVAL.CLASSIFICATION_FRACTIONS) and all(
        np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs.values())
    mine = {s: len(loader) for s, loader in loaders.items()}
    for i, (split, n) in enumerate(FG_SPLITS.items()):
        files = sorted(os.listdir(os.path.join(logdir, f"finegym_eval_{split}set")))
        ok &= (len(files) == n and len(lists[0][i]) == n
               and sorted(os.path.basename(f) for f in lists[0][i]) == files
               and mine[split] == n // size)
    frames = {s: sum(int(loader.dataset.entries[int(i)]["seq_len"])
                     for i in loader.sampler.indices()) for s, loader in loaders.items()}
    fps = {s: frames[s] / t for s, t in zip(FG_SPLITS, spans["dump"])}
    log(f"17c rank {rank} of {size}, fg99_mvf harness (seeded weights): its shard "
        f"{json.dumps(mine)} videos; every video dumped once "
        f"({'ok' if ok else 'FAIL'}); accuracies {json.dumps(accs)} on every rank; "
        f"dump {json.dumps({s: round(v, 1) for s, v in fps.items()})} frames/s "
        f"({json.dumps(frames)} frames of this rank in "
        f"{[round(t, 3) for t in spans['dump']]} s), probe "
        f"{[round(t, 3) for t in spans['probe']]} s a fraction on {card}")
    if not ok:
        raise AssertionError("17c: the FineGym harness at two ranks failed its checks")
    del model
    torch.cuda.empty_cache()
    return {"accs": accs, "dump_fps": fps, "dump_s": spans["dump"],
            "probe_s": spans["probe"], "shard_videos": mine}


def ddp_rank(rank, port, data_root, card):
    """17b and 17c as rank `rank` of two, both on card 0, over gloo (NCCL
    takes one rank a card). Returns every rank's numbers and this rank's
    launches."""
    from video_rep_learning_tpu_torch.parallel import all_gather_object, init_distributed

    # TF32 off on every rank, as `phase_environment` sets it for this process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", 2, rank, "cuda", backend="gloo",
                     timeout=DDP_TIMEOUT_S)
    nums, launches = {}, {}
    vit = vit_launches(2 * 240)  # a step's 2 views x 240 frames in 40-frame chunks
    mvf_want = dict(vit, crop_photometric=1, flash_attn_fwd=3, flash_attn_bwd=3,
                    scl_rowsum=1, scl_loss_rows=1, scl_srow=1, scl_grad=1)
    carl_want = {"crop_photometric": 1, "flash_attn_fwd": 2, "flash_attn_bwd": 2}
    nums["carl_ms"], _ = ddp_steps("scl_transformer_config (CARL, USE_AMP)", CFG_FILE,
                                   data_root, carl_want)
    launches["CARL steps"] = _read_launches()
    with env_vars(VRL_FUSED_SCL="1"):
        nums["mvf_ms"], _ = ddp_steps("pouring_mvf (VRL_FUSED_SCL=1, local N 480)",
                                      MVF_CFG_FILE, data_root, mvf_want)
    launches["MV-Former steps"] = _read_launches()
    _reset_launches()
    nums["fp32_loss"] = ddp_fp32_step(data_root)
    launches["fp32 step"] = _read_launches()
    nums["tcc_loss"] = ddp_tcc_step(data_root)
    launches["TCC step"] = _read_launches()
    _reset_launches()
    nums["finegym"] = ddp_finegym(card)
    launches["fg99 harness"] = _read_launches()
    everyone = all_gather_object(nums)
    torch.distributed.destroy_process_group()
    return everyone, launches


def phase_two_ranks(data_root, card):
    """17b-c: this process is rank 0, a second process started here rank 1,
    both on the one card (`ddp_rank`). Rank 1's output goes to
    WORK/ddp_rank1.log, whose end is shown if it fails; it is stopped
    whatever happens here."""
    from video_rep_learning_tpu_torch.tools.ddp_cards import free_port

    port = free_port()
    path = os.path.join(WORK, "ddp_rank1.log")
    code = (f"import chip_smoke; chip_smoke.ddp_rank(1, {port}, {data_root!r}, "
            f"{card!r})")
    with open(path, "w") as out:
        child = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=out,
                                 stderr=subprocess.STDOUT)
    try:
        everyone, launches = ddp_rank(0, port, data_root, card)
        child.wait(timeout=120)
    except BaseException:
        with open(path) as f:
            log("rank 1's output ends:\n" + f.read()[-6000:])
        raise
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        with open(path) as f:
            log("rank 1's output ends:\n" + f.read()[-6000:])
        raise AssertionError(f"rank 1 exited {child.returncode}")
    log("17b-c numbers by rank (two ranks share the card: correctness and "
        f"overhead, not scaling): {json.dumps(everyone)} on {card}")
    return launches, everyone


# ---------------------------------------------------------------------------
# phase 18: the trainer's device prefetch, the frame-packed and packed eval
# sweeps
# ---------------------------------------------------------------------------

PREFETCH_CFGS = {"CARL": CFG_FILE,
                 "tcc_transformer": SUP_CFGS["tcc_transformer_config"]}
# epochs a depth, the first of them warming up: CARL 6 steps an epoch (1
# clip), tcc_transformer 3 (2 clips); then one profiled epoch a depth, so
# at least 6 warm steps a depth
PREFETCH_EPOCHS = {"CARL": 2, "tcc_transformer": 2}
# the sweeps against the per-video sweep, max |embedding difference| of the
# unit-norm embeddings. fp32 (USE_AMP off, TF32 off): the CPU tests'
# tolerance (tests/test_torch_eval_sweeps.py, the JAX package's own 2e-6),
# the same per-frame math on blocks of another size. Under USE_AMP the
# trunk computes in bf16: where another block size makes cuDNN (ResNet) or
# cuBLAS (the ViT's fc2) sum in another order, a value may round to the
# neighbouring bf16 value, one step of 2^-8 of it; the fp32 head carries a
# relative change of its input into the unit-norm embedding at the same
# order, so one such step at unit scale, 2^-8 (for scale: rounding fc2's
# input at another point in all 12 ViT blocks, VRL_FUSED_MLP=1, moved the
# MV-Former embeddings by 1.364e-4 in an earlier run of phase 7)
SWEEP_TOL = {torch.float32: 2e-6, torch.bfloat16: 2.0 ** -8}
SWEEP_MODES = {"per_video": ("0", 1), "flat": ("1", 1), "packed2": ("0", 2),
               "packed4": ("0", 4)}


def _state_tensors(trainer):
    """Every tensor of the model's state and the optimizer's moments."""
    opt = trainer.optimizer
    return ([(n, t) for n, t in trainer.model.state_dict().items()]
            + [(f"mu.{i}", t) for i, t in enumerate(opt.mu)]
            + [(f"nu.{i}", t) for i, t in enumerate(opt.nu)])


def profile_epoch(trainer, epoch):
    """One epoch under torch.profiler: (wall s, kernel s, host-to-device copy
    s) on the card; its busy share is kernels over wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.train_one_epoch(epoch)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = sum(e.self_device_time_total for e in events if "HtoD" in e.key) / 1e6
    busy = sum(e.self_device_time_total for e in events) / 1e6 - h2d
    return wall, busy, h2d


def h2d_in_step_ms(trainer, batch, reps=3):
    """The serial copy's device time on the compute stream (CUDA events
    around `device_batch`), the mean of `reps`."""
    spans = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        trainer.device_batch(batch)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return sum(spans) / reps


def prefetch_pair(name, data_root, card):
    """18a: `name`'s trainer at DATA.DEVICE_PREFETCH 0 and 2 (two trainers
    from the same seed), their epochs in turns; launches exact and equal,
    every tensor and optimizer moment bit-identical after the last epoch.
    Returns (launches of the depth-2 run, numbers)."""
    from video_rep_learning_tpu_torch.train import Trainer

    cfg_file = PREFETCH_CFGS[name]
    trainers, launches, times, markers = {}, {}, {0: [], 2: []}, {}
    for depth in (0, 2):
        cfg = _ddp_cfg(cfg_file, data_root, ["DATA.DEVICE_PREFETCH", str(depth)])
        torch.manual_seed(SEED)
        trainers[depth] = Trainer(cfg, no_eval=True, device="cuda")
        launches[depth] = {}
    steps = len(trainers[0].train_loader)
    layers = trainers[0].cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    for epoch in range(PREFETCH_EPOCHS[name]):
        for depth, tr in trainers.items():
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            tr.train_one_epoch(epoch)
            torch.cuda.synchronize()
            if epoch:  # the first epoch warms up
                times[depth].append((time.time() - t0) / steps * 1e3)
            _add(launches[depth], _read_launches())
            markers[depth] = dict(tr.last_markers)
    copy_ms = trainers[2].prefetcher.h2d_ms()
    profiled = {}
    for depth, tr in trainers.items():
        _reset_launches()
        profiled[depth] = profile_epoch(tr, PREFETCH_EPOCHS[name])
        _add(launches[depth], _read_launches())
    from video_rep_learning_tpu_torch.train.trainer import BATCH_KEYS

    batch = next(iter(trainers[0].train_loader))
    in_step = h2d_in_step_ms(trainers[0], batch)
    nbytes = sum(np.asarray(batch[k]).nbytes for k in ("videos",) + BATCH_KEYS
                 if k in batch)

    epochs = PREFETCH_EPOCHS[name] + 1
    want = {"flash_attn_fwd": layers * steps * epochs,
            "flash_attn_bwd": layers * steps * epochs,
            "crop_photometric": steps * epochs if trainers[0].cfg.SSL else 0}
    for depth in (0, 2):
        got = {k: launches[depth][k] for k in want}
        if got != want:
            raise AssertionError(f"18a {name} depth {depth}: launches {got}, want {want}")
    same = diff = 0
    state0, state2 = _state_tensors(trainers[0]), _state_tensors(trainers[2])
    for (n, a), (_, b) in zip(state0, state2):
        if torch.equal(a, b):
            same += 1
        else:
            diff += 1
            log(f"18a {name}: {n} differs between depth 0 and depth 2")
    clips = trainers[0].cfg.TRAIN.BATCH_SIZE
    nums = {"ms_per_step": {d: times[d] for d in times},
            "busy_share": {d: profiled[d][1] / profiled[d][0] for d in profiled},
            "profiled_ms_per_step": {d: profiled[d][0] / steps * 1e3 for d in profiled},
            "h2d_ms": {"depth0_in_step": in_step,
                       "depth2_copy_stream": sum(copy_ms) / max(len(copy_ms), 1)},
            "h2d_GBps": {"depth0_pageable": nbytes / in_step / 1e6,
                         "depth2_pinned": nbytes / (sum(copy_ms) / max(len(copy_ms), 1))
                         / 1e6 if copy_ms else None},
            "h2d_device_ms_per_step_profiled": {d: profiled[d][2] / steps * 1e3
                                                for d in profiled},
            "markers": markers, "batch_MB": nbytes / 1e6}
    log(f"18a {name} ({steps} steps an epoch of {clips} clip(s), "
        f"{PREFETCH_EPOCHS[name] - 1} timed epochs a depth in turns, one profiled): "
        + "; ".join(
            f"depth {d}: {', '.join(f'{t:.1f}' for t in times[d])} ms/step "
            f"({clips / (sum(times[d]) / len(times[d])) * 1e3:.2f} clips/s), profiled "
            f"epoch {nums['profiled_ms_per_step'][d]:.1f} ms/step, busy "
            f"{nums['busy_share'][d] * 100:.1f}%, H2D on the card "
            f"{nums['h2d_device_ms_per_step_profiled'][d]:.2f} ms/step, markers "
            f"{json.dumps({k: round(v, 4) for k, v in markers[d].items()})}"
            for d in (0, 2))
        + f"; the batch's {nbytes / 1e6:.1f} MB: {in_step:.2f} ms in the step at depth 0 "
        f"({nums['h2d_GBps']['depth0_pageable']:.1f} GB/s pageable), "
        f"{nums['h2d_ms']['depth2_copy_stream']:.2f} ms on the copy stream at depth 2 "
        f"({nums['h2d_GBps']['depth2_pinned'] or 0:.1f} GB/s pinned); launches "
        f"{json.dumps(want)} at both depths; {same} tensors and moments bit-identical, "
        f"{diff} differ, on {card}")
    if diff or not same:
        raise AssertionError(f"18a {name}: depth 0 and depth 2 disagree")
    del trainers
    torch.cuda.empty_cache()
    return launches[2], nums


def prefetch_mvf(data_root, card):
    """18a: pouring_mvf (device-bound) at depth 2, then 0, then 2 again:
    ms/step of each epoch after a warm one."""
    from video_rep_learning_tpu_torch.train import Trainer

    torch.manual_seed(SEED)
    trainer = Trainer(_ddp_cfg(MVF_CFG_FILE, data_root), no_eval=True, device="cuda")
    steps = len(trainer.train_loader)
    trainer.train_one_epoch(0)  # warm
    _reset_launches()
    times = {}
    for epoch, depth in enumerate((2, 0, 2), 1):
        trainer.cfg.DATA.DEVICE_PREFETCH = depth
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_one_epoch(epoch)
        torch.cuda.synchronize()
        times.setdefault(depth, []).append((time.time() - t0) / steps * 1e3)
    launches = _read_launches()
    _check_vit_blocks("18a pouring_mvf", launches)
    log(f"18a pouring_mvf ({steps} steps an epoch): depth 2 "
        f"{', '.join(f'{t:.1f}' for t in times[2])} ms/step, depth 0 {times[0][0]:.1f} "
        f"ms/step (in turns 2, 0, 2); copy stream {np.mean(trainer.prefetcher.h2d_ms()):.2f} "
        f"ms a batch; launches {json.dumps(launches)} on {card}")
    del trainer
    torch.cuda.empty_cache()
    return launches, times


def sweep_launches(cfg, model, lens, sweep, pack=1):
    """#1's and #4's launches of a sweep over videos of these lengths:
    #1 once an encoder layer a head run; #4 once a ViT block a trunk chunk
    of MODEL.BASE_MODEL.FRAMES_PER_BATCH frames."""
    from video_rep_learning_tpu_torch.evaluation.embedding import _chunks, flat_block

    layers = cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS
    vit = model.spec.vit_spec
    chunk = model.spec.frames_per_batch
    trunk = lambda n: (-(-n // chunk)) * (vit.depth if vit else 0)  # noqa: E731
    fpb = cfg.EVAL.FRAMES_PER_BATCH
    if sweep == "packed":
        heads = vit_calls = 0
        for w in range(0, len(lens), 2 * pack):
            sizes = sorted((n for L in lens[w:w + 2 * pack] for _, n in _chunks(L, fpb)),
                           reverse=True)
            for g in range(0, len(sizes), pack):
                grp = sizes[g:g + pack]
                heads += 1
                vit_calls += trunk(len(grp) * grp[0])
        return {"flash_attn_fwd": layers * heads, "packed_attn": vit_calls}
    heads = sum(len(_chunks(L, fpb)) for L in lens)
    if sweep == "flat":
        fb, total = flat_block(cfg, model), sum(lens)
        blocks = [fb] * (total // fb) + ([total % fb] if total % fb else [])
        return {"flash_attn_fwd": layers * heads,
                "packed_attn": sum(trunk(b) for b in blocks)}
    return {"flash_attn_fwd": layers * heads,
            "packed_attn": sum(trunk(n) for L in lens for _, n in _chunks(L, fpb))}


@contextmanager
def sweep_mode(cfg, mode):
    flat, pack = SWEEP_MODES[mode]
    with env_vars(VRL_EVAL_FLAT=flat):
        cfg.EVAL.PACK_VIDEOS = pack
        try:
            yield
        finally:
            cfg.EVAL.PACK_VIDEOS = 1


def sweep_modes(what, cfg, model, items, lens, dtype, card, timed=True):
    """Each mode of `SWEEP_MODES` over `items` (a loader, or a list): its
    embeddings against the per-video sweep's within SWEEP_TOL[dtype], its
    exact #1 / #4 launches, and (with `timed`) its frames/s, after one
    untimed per-video pass. The launch counters keep counting across the
    modes."""
    from video_rep_learning_tpu_torch.evaluation.embedding import (eval_sweep,
                                                                   get_embeddings_dataset)

    frames = sum(lens)
    ref = ref_names = None
    out = {}
    for mode in SWEEP_MODES:
        with sweep_mode(cfg, mode):
            sweep = eval_sweep(cfg, model)
            if timed and ref is None:
                get_embeddings_dataset(cfg, model, items, "cuda")  # warm-up
            before = _read_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            got = get_embeddings_dataset(cfg, model, items, "cuda")
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = {k: v - before[k] for k, v in _read_launches().items()}
            want = sweep_launches(cfg, model, lens, sweep, SWEEP_MODES[mode][1])
        embs = np.concatenate(got["embs"])
        if ref is None:
            ref, ref_names = embs, got["names"]
        got_launches = {k: launches[k] for k in want}
        ok = (embs.shape == ref.shape and bool(np.isfinite(embs).all())
              and got["names"] == ref_names and got_launches == want)
        err = float(np.abs(embs - ref).max()) if embs.shape == ref.shape else float("inf")
        ok &= err <= SWEEP_TOL[dtype]
        out[mode] = {"sweep": sweep, "frames_per_s": frames / dt if timed else None,
                     "max_abs_diff": err, "launches": got_launches}
        log(f"18b {what} {mode:9s} ({sweep}): max |emb - per-video| {err:.3e} (tol "
            f"{SWEEP_TOL[dtype]:.1e}), launches {json.dumps(got_launches)} (expected "
            f"{json.dumps(want)})"
            + (f", {frames / dt:.1f} frames/s ({frames} frames in {dt:.3f} s)"
               if timed else "") + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"18b {what} {mode}: the sweep disagrees")
    return out


def fp32_items(data_root, lens=(70, 41, 55)):
    """Three val videos cut to uneven lengths, as eval items."""
    with open(os.path.join(data_root, "pouring", "val.pkl"), "rb") as f:
        entries = pickle.load(f)
    items = []
    for entry, n in zip(entries, lens):
        video = np.load(os.path.join(data_root, "pouring", entry["video_file"]))[:n]
        items.append({"video": video, "seq_len": n, "name": entry["name"],
                      "labels": np.asarray(entry["frame_label"])[:n],
                      "chosen_steps": np.arange(n),
                      "dims": np.array(video.shape[1:3], np.float32)})
    return items, list(lens)


def packed_group_attention(what, H, d, lens, tokens):
    """#1 masked at a packed group's shape (one entry a chunk of `lens`,
    `tokens` x max(lens) keys, the key mask from the chunks' true lengths
    repeated over the tokens as the MV-Former head lays it out) against its
    plain version, fp32 and bf16."""
    from video_rep_learning_tpu_torch.ops.attention import (attention_reference,
                                                            flash_attention_fwd)

    g = torch.Generator().manual_seed(SEED)
    L = max(lens)
    mask = (torch.arange(L)[None] < torch.tensor(lens)[:, None]).float()
    mask = mask.repeat(1, tokens).cuda()
    shape = (len(lens), H, tokens * L, d)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, mask, d ** -0.5)
        r_out, r_lse = attention_reference(q.float(), k.float(), v.float(), mask, d ** -0.5)
        e_out = (out.float() - r_out).abs().max().item()
        e_lse = (lse - r_lse).abs().max().item()
        ok = (e_out <= TOL[(dtype, "out")] and e_lse <= TOL[(dtype, "lse")]
              and bool(torch.isfinite(out.float()).all()))
        log(f"18b #1 at {what}'s packed group {shape} {str(dtype)[6:]}, key mask of "
            f"lengths {lens}: out err {e_out:.3e} (tol {TOL[(dtype, 'out')]:.1e}), lse "
            f"err {e_lse:.3e} (tol {TOL[(dtype, 'lse')]:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"#1 disagrees at {what}'s packed group")


def fg99_flat_dump(card):
    """18b: fg99_mvf's harness dump of the val split, per-video and with
    EVAL.FLAT_EXTRACT on: the same pickles within SWEEP_TOL[bf16]."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation import finegym
    from video_rep_learning_tpu_torch.models import build_model

    data_root = os.path.join(WORK, "data")
    if not os.path.isfile(os.path.join(data_root, "finegym", "gym99_val.pkl")):
        make_gym99_set()
    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", FG_CFG_FILE, "--opts", "DATA.NUM_WORKERS", "4"])[0])
    cfg.PATH_TO_DATASET = os.path.join(data_root, cfg.PATH_TO_DATASET)
    torch.manual_seed(SEED)
    model = build_model(cfg, "cuda")
    loader = cli.build_eval_loaders(cfg, "val")[0]
    dumps, spans = {}, {}
    _reset_launches()
    for flat in (False, True, False):  # the first warms up
        cfg.EVAL.FLAT_EXTRACT = flat
        out = os.path.join(WORK, "fg99_flat" if flat else "fg99_per_video")
        torch.cuda.synchronize()
        t0 = time.time()
        files, _ = finegym.dump_embeddings_dataset(cfg, model, loader, out, "cuda")
        torch.cuda.synchronize()
        spans[flat] = time.time() - t0
        dumps[flat] = files
    cfg.EVAL.FLAT_EXTRACT = False
    launches = _read_launches()
    frames = err = 0
    for a, b in zip(sorted(dumps[False]), sorted(dumps[True])):
        recs = []
        for path in (a, b):
            with open(path, "rb") as f:
                recs.append(pickle.load(f))
        frames += len(recs[0]["labels"])
        err = max(err, float(np.abs(recs[0]["embs"] - recs[1]["embs"]).max()))
        if not np.array_equal(recs[0]["labels"], recs[1]["labels"]):
            raise AssertionError("18b fg99: the dumps' labels differ")
    ok = (len(dumps[True]) == FG_SPLITS["val"] and err <= SWEEP_TOL[torch.bfloat16])
    log(f"18b fg99_mvf harness dump of the val split ({len(dumps[True])} pickles): "
        f"EVAL.FLAT_EXTRACT on {frames / spans[True]:.1f} labelled frames/s, off "
        f"{frames / spans[False]:.1f}; max |emb flat - per-video| {err:.3e} (tol "
        f"{SWEEP_TOL[torch.bfloat16]:.1e}); launches {json.dumps(launches)} on {card} "
        f"{'ok' if ok else 'FAIL'}")
    _check_vit_blocks("18b fg99 dumps", launches)
    if not ok:
        raise AssertionError("18b fg99: the flat dump disagrees")
    return launches, {"flat_fps": frames / spans[True], "per_video_fps": frames / spans[False],
                      "max_abs_diff": err}


def phase_sweeps(data_root, card):
    """18b: the CARL and pouring_mvf val sweeps in each mode under USE_AMP,
    then in fp32 on three cut videos (EVAL.FRAMES_PER_BATCH 32, trunk blocks
    of 48: chunks and blocks that split videos); #1 at a packed group's
    shape; fg99's flat dump. Returns (launches, numbers)."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.models import build_model

    launches, nums = {}, {}
    with open(os.path.join(data_root, "pouring", "val.pkl"), "rb") as f:
        val_lens = [int(e["seq_len"]) for e in pickle.load(f)]
    for what, cfg_file in (("CARL", CFG_FILE), ("pouring_mvf", MVF_CFG_FILE)):
        cfg = _ddp_cfg(cfg_file, data_root)
        torch.manual_seed(SEED)
        model = build_model(cfg, "cuda")
        loader = cli.build_eval_loaders(cfg, "val")[0]
        _reset_launches()
        nums[what] = sweep_modes(what, cfg, model, loader, val_lens, torch.bfloat16, card)
        launches[f"{what} sweeps"] = _read_launches()
        # the first packed group of P 4: the window's four longest chunks
        e = cfg.MODEL.EMBEDDER_MODEL
        packed_group_attention(what, e.NUM_HEADS, e.HIDDEN_SIZE // e.NUM_HEADS,
                               sorted(val_lens[:8], reverse=True)[:4],
                               e.SMART_TOKENS if model.spec.vit_spec else 1)
        del model
        torch.cuda.empty_cache()

        cfg = _ddp_cfg(cfg_file, data_root, ["USE_AMP", "False", "EVAL.FRAMES_PER_BATCH",
                                             "32", "EVAL.FLAT_BLOCK", "48"])
        torch.manual_seed(SEED)
        model = build_model(cfg, "cuda")
        items, lens = fp32_items(data_root)
        nums[what + " fp32"] = sweep_modes(what + " fp32", cfg, model, items, lens,
                                           torch.float32, card, timed=False)
        del model
        torch.cuda.empty_cache()
    launches["fg99 dumps"], nums["fg99"] = fg99_flat_dump(card)
    return launches, nums


def phase_bench_eval(card):
    """18c: `python -m video_rep_learning_tpu_torch.tools.bench_eval`'s run
    on its ragged set, one timed pass a mode; each mode within
    SWEEP_TOL[bf16] of the per-video sweep."""
    from video_rep_learning_tpu_torch.tools import bench_eval

    _reset_launches()
    rows = bench_eval.run("cuda", epochs=1)
    launches = _read_launches()
    bench_eval.show(rows)
    bad = [r for r in rows if r["max_abs_diff_vs_per_video"] > SWEEP_TOL[torch.bfloat16]]
    if bad:
        raise AssertionError(f"18c bench_eval: modes off the per-video sweep: {bad}")
    log(f"18c bench_eval on {card}: " + json.dumps(
        {f"{r['family']} {r['mode']}": round(r["frames_per_s"], 1) for r in rows}))
    return launches, rows


def phase_prefetch_and_sweeps(data_root, card):
    """18: the prefetch (a), the sweeps (b) and the ragged tool (c). Returns
    (each path's launches, numbers)."""
    t0 = time.time()
    launches, nums = {}, {}
    for name in PREFETCH_CFGS:
        launches[f"prefetch {name}"], nums[name] = prefetch_pair(name, data_root, card)
        log(f"18a {name}: {time.time() - t0:.1f} s into phase 18")
    launches["prefetch pouring_mvf"], nums["pouring_mvf_step"] = prefetch_mvf(data_root, card)
    log(f"18a: {time.time() - t0:.1f} s into phase 18")
    sweep_launches_, nums["sweeps"] = phase_sweeps(data_root, card)
    launches.update(sweep_launches_)
    log(f"18b: {time.time() - t0:.1f} s into phase 18")
    launches["bench_eval"], nums["bench_eval"] = phase_bench_eval(card)
    log(f"phase 18 in {time.time() - t0:.1f} s")
    return launches, nums

JAX_OPS = "video_rep_learning_tpu/ops/"
SOURCES = {  # name: (source under the port, the TPU kernel it replaces)
    "flash_attn_fwd": ("csrc/flash_attn_fwd.cu", JAX_OPS + "attention_pallas.py:79"),
    "flash_attn_bwd": ("csrc/flash_attn_bwd.cu", JAX_OPS + "attention_pallas.py:98"),
    "crop_photometric": ("csrc/photometric.cu", JAX_OPS + "photometric_pallas.py:218"),
    "photometric": ("csrc/photometric.cu", JAX_OPS + "photometric_pallas.py:208"),
    "layernorm": ("csrc/layernorm.cu", JAX_OPS + "layernorm_pallas.py:36"),
    # also both schedules of the TPU micro-benchmark (rows 13a, 13b):
    # `build_jouter` and `build_scratch`, whose rows phase 14 runs through #6
    "ln_gemm": ("csrc/ln_gemm.cu", JAX_OPS + "matmul_gelu_pallas.py:198",
                ("tools/bench_ln_matmul.py:46", "tools/bench_ln_matmul.py:85")),
    "matmul_bias_gelu": ("csrc/ln_gemm.cu", JAX_OPS + "matmul_gelu_pallas.py:72"),
    "ln_mlp_block": ("csrc/mlp_block.cu", JAX_OPS + "matmul_gelu_pallas.py:341"),
    "packed_attn": ("csrc/packed_attn.cu", JAX_OPS + "attention_pallas.py:485"),
    # three launches of csrc/ln_gemm.cu and csrc/packed_attn.cu
    "vit_attention_block": ("ops/vit_block.py", JAX_OPS + "vit_block_pallas.py:102"),
    "scl_rowsum": ("csrc/scl.cu", JAX_OPS + "scl_pallas.py:104"),
    "scl_loss_rows": ("csrc/scl.cu", JAX_OPS + "scl_pallas.py:122"),
    "scl_srow": ("csrc/scl.cu", JAX_OPS + "scl_pallas.py:151"),
    "scl_grad": ("csrc/scl.cu", JAX_OPS + "scl_pallas.py:176"),
    # row 13, the TPU micro-benchmarks (phase 14)
    # also bench_packed_attn.py:130 (build_multi), bench_attn_variants.py:108
    "packed_attn_variant": ("csrc/packed_attn_variants.cu",
                            "tools/bench_packed_attn.py:149"),
    "int8_gemm": ("csrc/int8_gemm.cu", "tools/bench_int8_pallas.py:37"),
    "elementwise_chain": ("csrc/elementwise_chain.cu", "tools/bench_vpu_bf16.py:53"),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only "
                 "on the GPU")
    card = phase_environment()
    ptxas, sass = phase_build()
    data_root, lens = make_synthetic_set()
    fwd_err, fg_attn = phase_kernel_vs_plain(lens)
    entries = phase_attention_backward()
    entries["flash_attn_fwd"]["max_abs_err"] = fwd_err
    entries["flash_attn_fwd"]["at_" + "x".join(map(str, FG_ATTN_SHAPE))] = fg_attn
    entries.update(phase_augment())
    entries.update(phase_vit_kernels())
    phase_vit_grads()
    entries.update(phase_scl_kernels())
    eval_launches = phase_main_path(data_root, card)
    phase_card_vs_cpu(data_root, os.path.join(WORK, "logs"))
    trainer, batch, train_launches = phase_train_path(data_root, card)
    phase_profile(trainer, batch)
    del trainer, batch
    step_launches = phase_step_card_vs_cpu(data_root)
    mvf_launches, mvf_logdir, fused_sweep = phase_mvf_path(data_root, card)
    entries["ln_mlp_block"]["mvf_eval_fused_mlp"] = fused_sweep
    phase_card_vs_cpu(data_root, mvf_logdir, MVF_CFG_FILE, MVF_CARD_VS_CPU,
                      "MV-Former")
    torch.cuda.empty_cache()
    mvf_train_launches = phase_mvf_train_path(data_root, card)
    torch.cuda.empty_cache()
    phase_mvf_fused_vs_plain(data_root)
    torch.cuda.empty_cache()
    phase_mvf_step_card_vs_cpu(data_root)
    torch.cuda.empty_cache()
    partial_launches = phase_partial_train_path(data_root, card)
    torch.cuda.empty_cache()
    phase_partial_step_card_vs_cpu(data_root)
    model_paths = {"training": train_launches, "fp32 step": step_launches,
                   "MV-Former eval": mvf_launches, "MV-Former training": mvf_train_launches,
                   "partial-ViT training": partial_launches}
    strays = {(path, k): n for path, counts in model_paths.items()
              for k, n in counts.items() if k in TOOL_ENTRIES and n}
    if strays:
        raise AssertionError(f"a model path launched a micro-benchmark kernel: {strays}")
    log("model paths: none of " + ", ".join(TOOL_ENTRIES) + " launched")
    torch.cuda.empty_cache()
    tool_entries, tool_launches = phase_tools(card)
    entries["ln_gemm"].update(tool_entries.pop("ln_gemm_tools"))
    entries.update(tool_entries)
    torch.cuda.empty_cache()
    sup_launches = phase_supervised(data_root, card, lens)
    strays = {(path, k): n for path, counts in sup_launches.items()
              for k, n in counts.items() if k in TOOL_ENTRIES and n}
    if strays:
        raise AssertionError(f"a supervised path launched a micro-benchmark kernel: "
                             f"{strays}")
    log("supervised paths: none of " + ", ".join(TOOL_ENTRIES) + " launched")
    torch.cuda.empty_cache()
    new_launches, late_nums = phase_late(data_root, card, lens)
    torch.cuda.empty_cache()
    new_launches["fg99 train + harness"], fg_nums = phase_finegym(card)
    torch.cuda.empty_cache()
    new_launches["mid-epoch resume"] = phase_mid_resume(data_root)
    strays = {(path, k): n for path, counts in new_launches.items()
              for k, n in counts.items() if k in TOOL_ENTRIES and n}
    if strays:
        raise AssertionError(f"a phase 16 path launched a micro-benchmark kernel: "
                             f"{strays}")
    log("phase 16 paths: none of " + ", ".join(TOOL_ENTRIES) + " launched")
    log("phase 16 numbers: " + json.dumps({"late": late_nums, "finegym": fg_nums}))
    torch.cuda.empty_cache()
    world1_launches, world1_nums = phase_ddp_world1(data_root, card)
    torch.cuda.empty_cache()
    ddp_launches, ddp_nums = phase_two_ranks(data_root, card)
    ddp_paths = {"world-1 NCCL, pouring_mvf CLI": world1_launches,
                 **{f"two ranks, rank 0: {k}": v for k, v in ddp_launches.items()}}
    strays = {(path, k): n for path, counts in ddp_paths.items()
              for k, n in counts.items() if k in TOOL_ENTRIES and n}
    if strays:
        raise AssertionError(f"a phase 17 path launched a micro-benchmark kernel: "
                             f"{strays}")
    log("phase 17 paths: none of " + ", ".join(TOOL_ENTRIES) + " launched")
    log("phase 17 numbers: " + json.dumps({"world1": world1_nums, "two_ranks": ddp_nums}))
    torch.cuda.empty_cache()
    p18_launches, p18_nums = phase_prefetch_and_sweeps(data_root, card)
    strays = {(path, k): n for path, counts in p18_launches.items()
              for k, n in counts.items() if k in TOOL_ENTRIES and n}
    if strays:
        raise AssertionError(f"a phase 18 path launched a micro-benchmark kernel: "
                             f"{strays}")
    log("phase 18 paths: none of " + ", ".join(TOOL_ENTRIES) + " launched")
    log("phase 18 numbers: " + json.dumps(p18_nums))
    # the kernels as built (PTXAS_KERNELS): registers, stack, spills; 13g's SASS
    for name, built in ptxas.items():
        entries[name]["ptxas"] = built
    entries["elementwise_chain"]["sass_reps_loop"] = sass
    kernels = []
    for name, (src, replaces, *also) in SOURCES.items():
        if name in TOOL_ENTRIES:
            path = "the micro-benchmarks' run('cuda') (phase 14)"
            launches = tool_launches[name]
        elif name in ("matmul_bias_gelu", "ln_mlp_block"):
            path = ("partial-ViT training (2 epochs under VRL_FUSED_MLP=1, a step on "
                    "each MLP route, warm steps)")
            launches = partial_launches[name]
        elif name in VIT_KERNELS:
            path, launches = "MV-Former eval", mvf_launches[name]
        elif name in SCL_PASSES:
            path = "MV-Former training (2 epochs, VRL_FUSED_SCL=1)"
            launches = mvf_train_launches[name]
        elif name == "photometric":
            path, launches = "fp32 training step", step_launches[name]
        else:
            path, launches = "training (2 epochs)", train_launches[name]
        e = entries[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"video_rep_learning_tpu_torch/{src}",
            "replaces": replaces,
            **({"also_replaces": list(also[0])} if also else {}),
            "launches": launches, "path": path,
            "eval_launches": eval_launches if name == "flash_attn_fwd" else 0,
            "mvf_eval_launches": mvf_launches[name],
            "mvf_train_launches": mvf_train_launches[name],
            "partial_train_launches": partial_launches.get(name, 0),
            "supervised_launches": {p: c[name] for p, c in sup_launches.items()},
            "phase16_launches": {p: c[name] for p, c in new_launches.items()},
            "phase17_launches": {p: c[name] for p, c in ddp_paths.items()},
            "phase18_launches": {p: c[name] for p, c in p18_launches.items()},
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": e["library_ms"],
            "host_ms": e["host_ms"],
            **{k: v for k, v in e.items() if k.endswith("_480")
               or k.startswith("at_") or k in ("row", "rows_ms", "rows_err", "rows_ms_b160", "slopes_ms",
                        "parts", "ptxas", "mvf_eval_fused_mlp", "no_mask", "sass_reps_loop",
                        "special_ok", "tail_cases")}})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
