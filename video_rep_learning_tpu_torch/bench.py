"""Training-step throughput of the two flagship workloads on one card, the
port's counterpart of the root `bench.py`:

1. CARL (`configs/scl_transformer_config.yml` shape): augmentation on the
   card (the crop + photometric kernel), frozen ResNet-50 trunk, trainable
   layer4, temporal transformer, SCL loss, backward and Adam; 1 clip x 2
   views x 240 frames at 224 px, bf16 backbone (USE_AMP).
2. MV-Former (`configs_mvf/penn_mvf.yml` shape): fully frozen ViT-B/8 with
   taps 3/7/11, LSTP with 3 entity tokens, the multi-entity temporal
   transformer; 1 clip x 2 views x 80 frames at 224 px, USE_AMP.

    python -m video_rep_learning_tpu_torch.bench [--device cuda|cpu] [--device-only]

Prints ONE JSON line on stdout with the root script's keys: "metric",
"value", "unit", "vs_baseline" for CARL and "mvf_*" for MV-Former. On the
card, unless `--device-only` (or VRL_BENCH_DEVICE_ONLY=1), it adds the
loader-fed rates (native decode -> loader -> device prefetch -> step) with
the decoded-frame cache on (2048 MB) and off in balanced order, their
overlap efficiency and data wait (marker 0), the K400-shape workload (2
clips x 2 views x 80 frames, batch_noself) device-only and loader-fed, and
each family's useful frames/s through the frame-packed eval sweep
(`tools/bench_eval.py`). Everything else (the card, the loader-fed reps,
the trainer's marker lines) goes to stderr. `--device cpu` runs the tiny
CPU shapes of the device-only branch; `cuda` without a card raises.

The `vs_baseline` anchors are the root script's: estimates of an A100
running the reference, derived from published ResNet-50 inference rates
and ViT-B/8 operation counts (BASELINE.md), not measurements:
- CARL 8 clips/s: 480 frozen ResNet-50 frames a step at ~2500 frames/s
  gives ~5.2 clips/s for the backbone alone, rounded up to 8 for perfect
  overlap of everything else;
- MV-Former 4 clips/s: ~25 TFLOP a step (160 ViT-B/8 frames) at half of
  the A100's 312 TFLOP/s bf16 peak, discounted for the tail.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .tools.common import card, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARL_ANCHOR_CLIPS_PER_SEC = 8.0
MVF_ANCHOR_CLIPS_PER_SEC = 4.0


def full_width(device) -> bool:
    """Full-width workloads on a card, the tiny CPU shapes on the CPU."""
    return torch.device(device).type == "cuda"


def raw_size(device) -> int:
    """The synthetic clips' canvas: 256 px on a card, 40 on the CPU."""
    return 256 if full_width(device) else 40


def carl_cfg(device="cuda"):
    from .config import get_cfg

    full = full_width(device)
    cfg = get_cfg()
    cfg.DATASETS = ["pouring"]
    cfg.TRAINING_ALGO = "scl"
    cfg.USE_AMP = True  # bf16 backbone
    cfg.TRAIN.BATCH_SIZE = 1
    cfg.TRAIN.NUM_FRAMES = 240 if full else 8
    cfg.IMAGE_SIZE = 224 if full else 32
    # the frozen trunk's chunk, a memory knob (the reference's 40 is a GPU
    # memory choice); `tools/sweep_frames_per_batch.py` measures it
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 120 if full else 4
    if not full:  # a narrow head on the CPU
        e = cfg.MODEL.EMBEDDER_MODEL
        e.NUM_LAYERS = 1
        e.HIDDEN_SIZE = 32
        e.D_FF = 64
        e.EMBEDDING_SIZE = 16
        e.FC_LAYERS = [[32, True]]
        e.CAPACITY_SCALAR = 1
        cfg.MODEL.PROJECTION_SIZE = 16
    cfg.EVAL.NUM_FRAMES = cfg.TRAIN.NUM_FRAMES
    return cfg


def k400_cfg(device="cuda"):
    """The `configs/scl_transformer_k400_pretrain_config.yml` workload shape:
    batch size 2, 80 frames, batch_noself SCL (batch collation and H2D at
    batch > 1, reference `kinetics400.py:135-182`)."""
    full = full_width(device)
    cfg = carl_cfg(device)
    cfg.DATASETS = ["kinetics400"]
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.NUM_FRAMES = 80 if full else 8
    cfg.EVAL.NUM_FRAMES = cfg.TRAIN.NUM_FRAMES
    # 2 clips x 2 views x 80 frames = 320: the trunk in 4 chunks of 80
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 80 if full else 4
    cfg.SCL.NEGATIVE_TYPE = "batch_noself"
    cfg.DATA.SAMPLING_STRATEGY = "time_augment"
    cfg.DATA.SAMPLING_REGION = 1.5
    cfg.DATA.CONSISTENT_OFFSET = 1.0
    return cfg


def mvf_cfg(device="cuda"):
    """The `configs_mvf/penn_mvf.yml` workload shape (on the CPU a ResNet
    trunk to layer3 under the same smart-fusion head, narrowed)."""
    from .config import get_cfg

    cfg = get_cfg()
    cfg.DATASETS = ["baseball_pitch"]
    cfg.TRAINING_ALGO = "scl"
    cfg.USE_AMP = True
    cfg.TRAIN.BATCH_SIZE = 1
    e = cfg.MODEL.EMBEDDER_MODEL
    e.FUSION_TYPE = "smart"
    e.SMART_TOKENS = 3
    e.SMART_ONE_HOT = "pool"
    e.SMART_FEATS = "3,7,11"
    e.SMART_FINAL = "one"
    if full_width(device):
        cfg.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_base_patch8_224.dino"
        cfg.MODEL.BASE_MODEL.LAYER = 12  # fully frozen
        cfg.TRAIN.NUM_FRAMES = 80
        cfg.IMAGE_SIZE = 224
        # the frozen ViT's chunk, a memory knob
        cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 160
    else:
        cfg.MODEL.BASE_MODEL.NETWORK = "Resnet50_byol"
        cfg.MODEL.BASE_MODEL.LAYER = 3
        cfg.TRAIN.NUM_FRAMES = 4
        cfg.IMAGE_SIZE = 32
        cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 4
        e.SMART_POOL_CHANNELS = 32
        e.HIDDEN_SIZE = 32
        e.D_FF = 64
        e.NUM_LAYERS = 1
        e.EMBEDDING_SIZE = 16
        e.FC_LAYERS = [[32, True]]
        e.CAPACITY_SCALAR = 1
        e.SMART_FEATS = None
        cfg.MODEL.PROJECTION_SIZE = 16
    cfg.EVAL.NUM_FRAMES = cfg.TRAIN.NUM_FRAMES
    return cfg


WORKLOADS = {"carl": carl_cfg, "mvf": mvf_cfg, "k400": k400_cfg}


def synthetic_batch(cfg, raw: int):
    """A host batch of B clips x 2 views of T random raw x raw uint8 frames,
    every frame valid, 4 source frames a step (seed 0)."""
    B, T = cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_FRAMES
    rng = np.random.RandomState(0)
    return {
        "videos": rng.randint(0, 255, size=(B, 2, T, raw, raw, 3)).astype(np.uint8),
        "labels": np.zeros((B, 2, T), np.int32),
        "seq_lens": np.full((B, 2), 4 * T, np.int32),
        "chosen_steps": np.tile(np.arange(T, dtype=np.int32) * 4, (B, 2, 1)),
        "video_masks": np.ones((B, 2, T), np.float32),
        "dims": np.full((B, 2), float(raw), np.float32),
    }


def step_setup(cfg, raw: int, device="cuda"):
    """(trainer, host batch, device batch): a trainer without loaders whose
    weights come from cfg.RNG_SEED, and the synthetic batch staged on the
    device once. Nothing is resumed from LOGDIR."""
    from .train import Trainer

    trainer = Trainer(cfg, no_eval=True, build_loaders=False, device=device)
    batch = synthetic_batch(cfg, raw)
    return trainer, batch, trainer.device_batch(batch)


def _measure(cfg, n_steps, raw, device="cuda"):
    """Clips/s of the warm train step on one device: 2 untimed steps, then
    `n_steps` timed ones, ended by one read of the last loss (the steps run
    in order on one stream, so it waits for all of them)."""
    trainer, batch, dev_batch = step_setup(cfg, raw, device)
    for i in range(2):
        loss = trainer.train_step(batch, dev_batch, 0, i, 1e-4)
    float(loss)
    t0 = time.perf_counter()
    for i in range(n_steps):
        loss = trainer.train_step(batch, dev_batch, 0, 100 + i, 1e-4)
    float(loss)
    dt = time.perf_counter() - t0
    return cfg.TRAIN.BATCH_SIZE * n_steps / dt


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _ensure_bench_dataset():
    """The loader-fed set: 8 + 2 Pouring-format mp4 videos of 260-330 frames
    at 256 px (the real Pouring shape class), made once under
    VRL_BENCH_DATA (default `build/bench_data_256` in the checkout). A set
    already there is used as it is: on a machine without FFmpeg, make it
    with `data/synthetic.py --format npy` and point VRL_BENCH_DATA at it."""
    from .data.synthetic import make_dataset

    out = os.environ.get("VRL_BENCH_DATA",
                         os.path.join(REPO, "build", "bench_data_256"))
    if not os.path.isfile(os.path.join(out, "train.pkl")):
        make_dataset(out, "pouring", "mp4", num_train=8, num_val=2, min_len=260,
                     max_len=330, size=256)
    return out


def _ensure_bench_dataset_k400():
    """The K400-format set (train/*.mp4 + train.csv, 6 videos of 130-170
    frames at 256 px) under VRL_BENCH_DATA_K400 (default
    `build/bench_data_k400`), or a set already there (`.npy` stores, as
    above)."""
    from .data.synthetic import make_dataset

    out = os.environ.get("VRL_BENCH_DATA_K400",
                         os.path.join(REPO, "build", "bench_data_k400"))
    if not os.path.isfile(os.path.join(out, "train.csv")):
        make_dataset(out, "kinetics400", "mp4", num_train=6, min_len=130,
                     max_len=170, size=256)
    return out


def _measure_loader_fed(cfg, data_dir, cache_mb, timed_epochs=2, device="cuda"):
    """(clips/s, the last epoch's markers) of training through the real input
    pipeline: native decode -> threaded loader -> device prefetch -> step,
    the reference's number-defining loop (`train.py:94-107`, markers 0/1/2).
    Epoch 0 (decode-cache fill) is untimed; each timed epoch ends in the
    loss read that waits for its steps. A fresh LOGDIR each time, so that
    nothing resumes."""
    from .data.cache import reset_decode_cache
    from .train import Trainer

    os.environ["VRL_DECODE_CACHE_MB"] = str(cache_mb)
    reset_decode_cache()
    logdir = tempfile.mkdtemp(prefix="vrl_bench_logs_")
    try:
        cfg.PATH_TO_DATASET = data_dir
        if cfg.DATASETS[0] != "kinetics400":
            cfg.DATASETS = ["pouring"]
        cfg.LOGGING.REPORT_INTERVAL = 10 ** 9
        cfg.LOGDIR = logdir
        trainer = Trainer(cfg, no_eval=True, build_loaders=True, device=device)
        trainer.init_state()
        # the trainer's "marker i:" lines go to stdout; the bench's stdout is
        # its one JSON line
        with contextlib.redirect_stdout(sys.stderr):
            trainer.train_one_epoch(0)
            n_clips = 0
            t0 = time.perf_counter()
            for e in range(1, 1 + timed_epochs):
                trainer.train_one_epoch(e)
                n_clips += len(trainer.train_loader) * cfg.TRAIN.BATCH_SIZE
            dt = time.perf_counter() - t0
        return n_clips / dt, dict(trainer.last_markers)
    finally:
        reset_decode_cache()
        os.environ.pop("VRL_DECODE_CACHE_MB", None)
        shutil.rmtree(logdir, ignore_errors=True)


def _loader_fed_reps(cfg_fn, data_dir, reps, device):
    """Loader-fed rates and markers with the cache off (0) and on (2048 MB),
    `reps` pairs in balanced order (off-on, on-off, ...): the host's rate
    drifts over minutes, and a fixed order would charge the drift to
    whichever setting runs second."""
    rates = {0: [], 2048: []}
    marks = {0: [], 2048: []}
    for rep in range(reps):
        for cache_mb in ((0, 2048) if rep % 2 == 0 else (2048, 0)):
            r, mk = _measure_loader_fed(cfg_fn(device), data_dir, cache_mb,
                                        device=device)
            rates[cache_mb].append(r)
            marks[cache_mb].append(mk)
    return rates, marks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--device-only", action="store_true",
                   help="only the device-step rates (also VRL_BENCH_DEVICE_ONLY=1)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    full = dev.type == "cuda"
    if full:
        print(card(), file=sys.stderr, flush=True)
    raw = raw_size(dev)
    carl = _measure(carl_cfg(dev), 8 if full else 2, raw, dev)
    mvf = _measure(mvf_cfg(dev), 8 if full else 2, raw, dev)
    result = {
        "metric": "scl_train_clips_per_sec_per_chip",
        "value": round(carl, 4),
        "unit": "clips/s/chip",
        "vs_baseline": round(carl / CARL_ANCHOR_CLIPS_PER_SEC, 4),
        "mvf_metric": "mvf_train_clips_per_sec_per_chip",
        "mvf_value": round(mvf, 4),
        "mvf_vs_baseline": round(mvf / MVF_ANCHOR_CLIPS_PER_SEC, 4),
    }

    # loader-fed: the device-step rate above hides the input pipeline; this
    # one includes decode + collate + H2D. Overlap efficiency = loader-fed
    # rate / device-step rate.
    device_only = args.device_only or os.environ.get("VRL_BENCH_DEVICE_ONLY", "0") == "1"
    if full and not device_only:
        data_dir = _ensure_bench_dataset()
        for name, cfg_fn, dev_rate in (("carl", carl_cfg, carl), ("mvf", mvf_cfg, mvf)):
            rates, marks = _loader_fed_reps(cfg_fn, data_dir, 4, dev)
            r_on = _median(rates[2048])
            result[f"{name}_loaderfed_value"] = round(r_on, 4)
            result[f"{name}_loaderfed_nocache_value"] = round(_median(rates[0]), 4)
            result[f"{name}_overlap_eff"] = round(r_on / dev_rate, 4)
            # the cache's effect as the median of paired (adjacent in time)
            # on/off ratios, which cancels the drift between pairs
            pair_ratios = sorted(on / off for on, off in zip(rates[2048], rates[0]))
            result[f"{name}_cache_speedup"] = round(_median(pair_ratios), 4)
            # median data wait a step (marker 0): the cache's direct effect
            for cache_mb, key in ((2048, "wait_s"), (0, "wait_nocache_s")):
                result[f"{name}_{key}"] = round(
                    _median([m.get(0, 0.0) for m in marks[cache_mb]]), 4)
            print(f"# {name} loader-fed reps cache-on {rates[2048]} cache-off "
                  f"{rates[0]} pair_ratios {pair_ratios} markers on {marks[2048]} "
                  f"off {marks[0]}", file=sys.stderr, flush=True)

        k400_dev = _measure(k400_cfg(dev), 8, raw, dev)
        result["k400_value"] = round(k400_dev, 4)
        k_rates, k_marks = _loader_fed_reps(k400_cfg, _ensure_bench_dataset_k400(), 2, dev)
        result["k400_loaderfed_value"] = round(_median(k_rates[2048]), 4)
        result["k400_loaderfed_nocache_value"] = round(_median(k_rates[0]), 4)
        result["k400_overlap_eff"] = round(_median(k_rates[2048]) / k400_dev, 4)
        result["k400_wait_s"] = round(_median([m.get(0, 0.0) for m in k_marks[2048]]), 4)
        print(f"# k400 loader-fed reps cache-on {k_rates[2048]} cache-off "
              f"{k_rates[0]}", file=sys.stderr, flush=True)

        # ragged eval extraction (the FineGym sweep's wall-clock dominator):
        # useful frames/s through the frame-packed sweep on a FineGym-like
        # length mix staged on the device
        from .tools import bench_eval

        with contextlib.redirect_stdout(sys.stderr):
            for name in ("carl", "mvf"):
                rows = bench_eval.run(dev, families=(name,), modes=("flat",), epochs=2)
                bench_eval.show(rows)
                result[f"{name}_eval_useful_fps"] = round(rows[0]["frames_per_s"], 1)

    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
