"""Standalone checkpoint evaluation on the GPU: restore the newest
`LOGDIR/checkpoints/checkpoint_epoch_*.pth` and run the downstream
evaluation once.

    python -m video_rep_learning_tpu_torch.evaluate --workdir DATA_ROOT \\
        --cfg_file configs/scl_transformer_config.yml --logdir LOGDIR \\
        [--device cuda] [--opts KEY VALUE ...]

The flags are the root `evaluate.py`'s, plus `--device` (default cuda). The
port's counterpart of that script. A FineGym config (DATASETS[0] finegym)
runs the FineGym harness (`evaluation/finegym.py`: per-video embedding
pickles, then the linear probe per fraction) in place of the embedding
tasks; `python -m video_rep_learning_tpu_torch.evaluate_finegym` is the same
entry point under the reference's name. With `--coordinator HOST:PORT
--num_processes N --process_id R` (one process per card, as for training)
the FineGym harness runs on every rank over its shard, and the other tasks
on rank 0 alone.
"""

from __future__ import annotations

import argparse
import os
import pprint
import time

import torch

from . import logging_utils
from .data import construct_dataloader
from .evaluation import finegym, get_tasks
from .evaluation.evaluate import evaluate_once
from .models import build_model, load_checkpoint
from .parallel import is_root_proc, process_group, synchronize
from .parser import load_config, parse_args, setup_train_dir
from .utils import SummaryWriter

logger = logging_utils.get_logger(__name__)


def build_eval_loaders(cfg, split: str):
    """The embedding loaders of `construct_dataloader` (one full-video sweep
    loader per dataset; FineGym's over its train or val index)."""
    return construct_dataloader(cfg, split)[1]


def parse_cli(argv=None):
    """(args, device): the root evaluate.py's flags plus `--device`."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda)")
    dev_args, rest = pre.parse_known_args(argv)
    return parse_args(rest), torch.device(dev_args.device)


def main(argv=None):
    args, device = parse_cli(argv)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch sees no CUDA device")
    with process_group(args.coordinator, args.num_processes, args.process_id,
                       device) as device:
        cfg = load_config(args)
        setup_train_dir(cfg, cfg.LOGDIR, True, args.tempcfg)
        cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)

        logging_utils.setup_logging(cfg.LOGDIR)
        summary_writer = (SummaryWriter(os.path.join(cfg.LOGDIR, "eval_logs"))
                          if is_root_proc() else None)
        logger.info("Evaluate with config:")
        logger.info(pprint.pformat(cfg.to_plain()))

        model = build_model(cfg, device)
        epoch = load_checkpoint(model, cfg.LOGDIR)

        metrics = None
        # the FineGym harness runs on every rank; the tasks, whose loaders
        # are not sharded, on rank 0
        if cfg.DATASETS[0] == "finegym" or is_root_proc():
            train_loaders = build_eval_loaders(cfg, "train")
            val_loaders = build_eval_loaders(cfg, "val")
            t0 = time.time()
            if cfg.DATASETS[0] == "finegym":
                metrics = finegym.evaluate_loaders(cfg, model, train_loaders[0],
                                                   val_loaders[0], epoch,
                                                   summary_writer, device)
            else:
                iterator_tasks, embedding_tasks = get_tasks(cfg)
                metrics = evaluate_once(cfg, model, train_loaders, val_loaders,
                                        iterator_tasks, embedding_tasks, epoch,
                                        summary_writer, device)
            print("evaluate_once done in (m): " + str((time.time() - t0) / 60.0))
        synchronize()
        if summary_writer is not None:
            summary_writer.close()
    return metrics


if __name__ == "__main__":
    main()
