"""Eval-sweep throughput: useful frames/s of the embedding sweeps on a
ragged FineGym-like set, the counterpart of `tools/bench_eval.py --ragged`.

    python -m video_rep_learning_tpu_torch.tools.bench_eval [--device cuda]
        [--family carl|mvf|both] [--epochs 2] [--modes per_video,flat,packed2,packed4]
        [--lengths 65,90,...] [--opts KEY VALUE ...]

For each family (CARL: `configs/scl_transformer_config.yml`; MV-Former:
`configs_mvf/pouring_mvf.yml`; full width, seeded random weights) it stages
ten videos of 65-310 frames (128 x 128 uint8, resized to IMAGE_SIZE on the
device) on the device once, then runs `iter_video_embeddings` over them at
EVAL.FRAMES_PER_BATCH 2000 (the FineGym configs') in each mode:
- per_video: each video through the whole model at its exact length;
- flat: the frame-packed sweep (VRL_EVAL_FLAT=1), trunk blocks of
  `flat_block` frames across videos;
- packed2, packed4: EVAL.PACK_VIDEOS 2 and 4, length-sorted groups padded
  to their longest chunk.
A mode's first pass is untimed; its time is the best of `--epochs` passes,
each ended by the records' copy to the host (which waits for the device).
It prints the card, one line a mode (useful frames/s, ms a pass, #1's and
#4's launches in a pass, the largest |difference| from the per-video
sweep's embeddings), then all rows as one JSON line. The JAX tool's pow2
and ladder modes pad to buckets, which the port does not have.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from .common import card, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAMILIES = {"carl": os.path.join(REPO, "configs", "scl_transformer_config.yml"),
            "mvf": os.path.join(REPO, "configs_mvf", "pouring_mvf.yml")}
LENGTHS = (65, 90, 118, 129, 151, 175, 198, 226, 240, 310)  # FineGym events
RAW = 128
# mode: (VRL_EVAL_FLAT, EVAL.PACK_VIDEOS, the sweep it runs)
MODES = {"per_video": ("0", 1, "per_video"), "flat": ("1", 1, "flat"),
         "packed2": ("0", 2, "packed"), "packed4": ("0", 4, "packed")}
# the plain versions on the CPU: CARL at 32 px with a narrow head
CPU_SHAPES = {"families": ("carl",), "lengths": (5, 9, 7, 12), "raw": 40, "epochs": 1,
              "opts": ("IMAGE_SIZE", "32", "USE_AMP", "False",
                       "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
                       "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
                       "MODEL.EMBEDDER_MODEL.D_FF", "64",
                       "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
                       "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1")}


def family_cfg(name: str, opts=()):
    from ..config import apply_opts, get_cfg, load_yaml_into

    cfg = get_cfg()
    load_yaml_into(cfg, FAMILIES[name])
    apply_opts(cfg, ["EVAL.FRAMES_PER_BATCH", "2000", *opts])
    return cfg


def ragged_items(lengths, raw: int, device, seed: int = 0):
    """Eval items of the given lengths, their frames on `device`."""
    rng = np.random.RandomState(seed)
    return [{"video": torch.as_tensor(rng.randint(0, 256, (n, raw, raw, 3), np.uint8),
                                      device=device),
             "labels": np.zeros(n, np.int64), "seq_len": n,
             "dims": np.array([raw, raw], np.float32), "chosen_steps": np.arange(n),
             "name": f"v{i}"} for i, n in enumerate(lengths)]


@contextmanager
def _flat_switch(value: str):
    old = os.environ.get("VRL_EVAL_FLAT")
    os.environ["VRL_EVAL_FLAT"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["VRL_EVAL_FLAT"]
        else:
            os.environ["VRL_EVAL_FLAT"] = old


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device="cuda", families=("carl", "mvf"), lengths=LENGTHS, raw=RAW, epochs=2,
        modes=tuple(MODES), opts=()):
    """One row a (family, mode): useful frames/s, ms a pass, the launches of
    #1 and #4 in a pass, and the largest |difference| from the per-video
    embeddings (None without a per-video mode)."""
    from ..evaluation.embedding import eval_sweep, flat_block, iter_video_embeddings
    from ..models import build_model
    from ..ops.attention import flash_attention_fwd, packed_vit_attention

    dev = resolve_device(device)
    useful = int(sum(lengths))
    rows = []
    for fam in families:
        cfg = family_cfg(fam, opts)
        torch.manual_seed(0)
        model = build_model(cfg, dev)
        items = ragged_items(lengths, raw, dev)
        ref = None
        for mode in modes:
            flat, pack, sweep = MODES[mode]
            cfg.EVAL.PACK_VIDEOS = pack
            with _flat_switch(flat):
                if eval_sweep(cfg, model) != sweep:
                    raise AssertionError(f"{fam} {mode}: the dispatch picked "
                                         f"{eval_sweep(cfg, model)}")
                best = float("inf")
                for e in range(epochs + 1):
                    _sync(dev)
                    before = (flash_attention_fwd.launches, packed_vit_attention.launches)
                    t0 = time.perf_counter()
                    out = list(iter_video_embeddings(cfg, model, items, dev))
                    _sync(dev)
                    if e:
                        best = min(best, time.perf_counter() - t0)
            embs = np.concatenate([r["embs"] for r in out])
            if embs.shape[0] != useful or not np.isfinite(embs).all():
                raise AssertionError(f"{fam} {mode}: {embs.shape} embeddings, "
                                     f"finite {np.isfinite(embs).all()}")
            if mode == "per_video":
                ref = embs
            rows.append({
                "family": fam, "mode": mode, "sweep": sweep,
                "flat_block": flat_block(cfg, model) if sweep == "flat" else None,
                "useful_frames": useful, "frames_per_s": useful / best,
                "ms": best * 1e3, "device": str(dev),
                "launches": {"flash_attn_fwd": flash_attention_fwd.launches - before[0],
                             "packed_attn": packed_vit_attention.launches - before[1]},
                "max_abs_diff_vs_per_video": (None if ref is None else
                                              float(np.abs(embs - ref).max()))})
        cfg.EVAL.PACK_VIDEOS = 1
        del model, items
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def show(rows):
    for r in rows:
        diff = r["max_abs_diff_vs_per_video"]
        print(f"{r['family']}: ragged {r['mode']:9s} {r['frames_per_s']:9.1f} useful "
              f"frames/s ({r['ms']:.1f} ms a pass of {r['useful_frames']} frames); "
              f"launches #1 {r['launches']['flash_attn_fwd']}, #4 "
              f"{r['launches']['packed_attn']}; max |diff| vs per-video "
              + ("not measured" if diff is None else f"{diff:.3e}"), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--family", choices=["carl", "mvf", "both"], default="both")
    p.add_argument("--epochs", type=int, default=None,
                   help="timed passes a mode (best of; default 2, 1 on the CPU)")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--lengths", default=None,
                   help="comma list of video lengths (default: 65..310 events)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    kw = {} if dev.type == "cuda" else dict(CPU_SHAPES)
    if dev.type == "cuda":
        print(card(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        print("cpu: the plain versions, a CARL model at 32 px", flush=True)
    if args.family != "both":
        kw["families"] = (args.family,)
    if args.epochs is not None:
        kw["epochs"] = args.epochs
    if args.lengths:
        kw["lengths"] = tuple(int(x) for x in args.lengths.split(","))
    kw["modes"] = tuple(args.modes.split(","))
    kw["opts"] = tuple(kw.get("opts", ())) + tuple(args.opts)
    rows = run(args.device, **kw)
    show(rows)
    print(json.dumps({"rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
