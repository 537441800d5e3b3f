"""Data parallelism across the cards of one machine: warm training steps of
a config at each world size, one process a card.

    python -m video_rep_learning_tpu_torch.tools.ddp_cards --workdir DATA_ROOT \\
        --cfg_file configs_mvf/pouring_mvf.yml [--worlds 1 2 4] [--steps 5] \\
        [--device cuda] [--opts KEY VALUE ...]

For each world size W it starts W processes, rank r on card r over NCCL
(gloo on the CPU with `--device cpu`), joined at a free local port. Each
builds the trainer of the config (`--opts` over it; seeded weights, its
loader's shard), takes its first batch, runs one untimed and `--steps`
timed train steps (host clock, synchronised by reading the loss), and
after every step all ranks compare digests of their trainable tensors and
buffers, which must be equal. It prints one JSON line a world: each rank's
ms/step, the world's clips/s (W x TRAIN.BATCH_SIZE over the slowest rank's
step), rank 0's losses, and the device with, on cards, the name and power
limit `nvidia-smi` gives. A rank that fails makes the run exit nonzero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def state_digest(model) -> str:
    """A digest of every trainable tensor and every buffer (the BN
    statistics): equal digests across ranks mean bit-identical states."""
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if p.requires_grad:
            h.update(n.encode() + p.detach().cpu().numpy().tobytes())
    for n, b in model.named_buffers():
        h.update(n.encode() + b.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_main(args):
    """One rank: the trainer's warm steps, the ranks' digests after each."""
    import torch

    from ..evaluate import parse_cli
    from ..parallel import all_gather_object, process_group
    from ..parser import load_config
    from ..train import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cli_args, _ = parse_cli(["--cfg_file", args.cfg_file, "--opts", *args.opts])
    with process_group(f"127.0.0.1:{args.port}", args.world, args.rank,
                       args.device) as device:
        cfg = load_config(cli_args)
        cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)
        trainer = Trainer(cfg, no_eval=True, device=device)
        trainer.train_loader.set_epoch(0)
        batch = next(iter(trainer.train_loader))
        losses, spent = [], 0.0
        for it in range(args.steps + 1):
            t0 = time.time()
            losses.append(float(trainer.train_step(batch, trainer.device_batch(batch),
                                                   0, it, 1e-4)))
            spent += (time.time() - t0) if it else 0.0
            digests = all_gather_object(state_digest(trainer.model))
            if len(set(digests)) != 1:
                raise AssertionError(f"step {it}: the ranks' states differ")
        result = {"rank": args.rank, "ms": spent / args.steps * 1e3, "losses": losses[1:],
                  "clips": int(batch["videos"].shape[0])}
    with open(args.out, "w") as f:
        json.dump(result, f)


def free_port() -> int:
    """A local port no process listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, args) -> dict:
    """W rank processes of this module; their results, or an error naming
    the rank that failed (every rank is stopped)."""
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--rank", str(r), "--world",
             str(world), "--port", str(port), "--out", outs[r], "--workdir",
             args.workdir, "--cfg_file", args.cfg_file, "--steps", str(args.steps),
             "--device", args.device, "--opts", *args.opts]) for r in range(world)]
        try:
            codes = [p.wait(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"world {world}: rank exit codes {codes}")
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    slowest = max(r["ms"] for r in ranks)
    return {"world": world, "ms_by_rank": [r["ms"] for r in ranks],
            "clips_per_s": sum(r["clips"] for r in ranks) / slowest * 1e3,
            "losses_rank0": ranks[0]["losses"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--rank", type=int, default=None)  # set on the rank processes
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    device = {"platform": args.device}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < max(args.worlds):
            raise RuntimeError(f"--worlds {args.worlds} needs as many cards; "
                               f"torch sees {torch.cuda.device_count()}")
        device["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for world in args.worlds:
        print(json.dumps(dict(run_world(world, args), cfg=args.cfg_file,
                              device=device)), flush=True)


if __name__ == "__main__":
    main()
