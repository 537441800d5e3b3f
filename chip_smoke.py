#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
drives the CARL embedding path end to end at full model width, and compares
the card's embeddings with the CPU's.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc builds `video_rep_learning_tpu_torch/csrc/*.cu`;
3. kernel vs plain: flash-attention forward in fp32 and bf16 at the CARL
   shapes, a long key range, padded keys and a fully masked row;
4. main path: `python -m video_rep_learning_tpu_torch.evaluate`'s function on a
   synthetic Pouring set with a full-width CARL model (seeded weights) and the
   kendalls_tau + retrieval tasks; checks launches, finiteness, unit norm and
   frame counts; reports frames/s;
5. card vs CPU: one 96-frame video through the whole path in fp32.

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

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
CFG_FILE = os.path.join(REPO, "configs", "scl_transformer_config.yml")
SEED = 0
# the CARL eval path gives the encoder (1, 8, n, 32) fp32 with n <= 1000
CARL_TIMING_SHAPES = [(1, 8, 240, 32), (1, 8, 1000, 32)]
TOL = {  # max |kernel - plain(fp32)|
    # fp32: the same fp32 math summed in another order
    (torch.float32, "out"): 1e-5, (torch.float32, "lse"): 1e-4,
    # bf16: the kernel's output is rounded to bf16 (half an ulp is 2^-9 of
    # |out| <= ~4); its LSE stays fp32
    (torch.bfloat16, "out"): 1.6e-2, (torch.bfloat16, "lse"): 1e-4,
}
CARD_VS_CPU_TOL = 1e-3  # unit-norm embeddings, fp32 on both, TF32 off


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
    from video_rep_learning_tpu_torch.ops import cuda_build

    t0 = time.time()
    built = not cuda_build.library_path("flash_attn_fwd").exists()
    so = cuda_build.build("flash_attn_fwd")
    log(f"build flash_attn_fwd: {'built' if built else 'found'} {so.name} in "
        f"{time.time() - t0:.2f} s")
    log_path = so.with_name(so.name + ".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())


def make_synthetic_set():
    data = os.path.join(WORK, "data", "pouring")
    shutil.rmtree(WORK, ignore_errors=True)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_data.py"),
         "--out", data, "--num_train", "6", "--num_val", "6",
         "--min_len", "150", "--max_len", "600", "--size", "256",
         "--format", "npy", "--seed", str(SEED)],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
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

    times = {}
    for shape in CARL_TIMING_SHAPES:
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        scale = shape[-1] ** -0.5
        kern = lambda: flash_attention_fwd(q, k, v, None, scale)  # noqa: E731
        plain = lambda: attention_reference(q, k, v, None, scale)  # noqa: E731
        # alternate plain, kernel, kernel, plain: both see the same clocks
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
        times[shape] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time {shape} fp32: flash_attn_fwd kernel {times[shape][0]:.4f} ms"
            f" ({k1:.4f}, {k2:.4f})")
        log(f"time {shape} fp32: plain attention_reference "
            f"{times[shape][1]:.4f} ms ({p1:.4f}, {p2:.4f})")
    return main_err, times[CARL_TIMING_SHAPES[-1]]


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
        raise AssertionError("the main path never launched flash_attn_fwd")
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


def phase_card_vs_cpu(data_root, logdir):
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.evaluation.embedding import \
        get_embeddings_dataset
    from video_rep_learning_tpu_torch.models import build_model, load_checkpoint

    cfg = cli.load_config(cli.parse_cli(
        ["--cfg_file", CFG_FILE, "--logdir", logdir, "--opts", "USE_AMP",
         "False"])[0])
    with open(os.path.join(data_root, "pouring", "val.pkl"), "rb") as f:
        entry = pickle.load(f)[0]
    video = np.load(os.path.join(data_root, "pouring", entry["video_file"]))[:96]
    item = {"video": video, "seq_len": 96, "name": entry["name"],
            "labels": np.asarray(entry["frame_label"])[:96],
            "chosen_steps": np.arange(96),
            "dims": np.array(video.shape[1:3], np.float32)}
    embs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        load_checkpoint(model, logdir)
        embs[dev] = get_embeddings_dataset(cfg, model, [item], dev)["embs"][0]
    err = float(np.abs(embs["cuda"] - embs["cpu"]).max())
    ok = embs["cuda"].shape == (96, 128) and err <= CARD_VS_CPU_TOL
    log(f"card vs CPU, one 96-frame video, fp32 (TF32 off): max |emb diff| "
        f"{err:.3e} (tol {CARD_VS_CPU_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU embeddings disagree")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only "
                 "on the GPU")
    card = phase_environment()
    phase_build()
    data_root, lens = make_synthetic_set()
    max_err, (ms, plain_ms) = phase_kernel_vs_plain(lens)
    launches = phase_main_path(data_root, card)
    phase_card_vs_cpu(data_root, os.path.join(WORK, "logs"))
    log(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "video_rep_learning_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "video_rep_learning_tpu/ops/attention_pallas.py:79",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
