"""Training on the GPU: CARL or MV-Former with SCL and the port's kernels,
auto-resuming from the newest `LOGDIR/checkpoints/checkpoint_epoch_*.pth`,
with the downstream evaluation after the last epoch.

    python -m video_rep_learning_tpu_torch.train --workdir DATA_ROOT \\
        --cfg_file configs/scl_transformer_config.yml --logdir LOGDIR \\
        [--continue_train] [--device cuda] [--opts KEY VALUE ...]
    python -m video_rep_learning_tpu_torch.train --workdir DATA_ROOT \\
        --cfg_file configs_mvf/pouring_mvf.yml --logdir LOGDIR \\
        --opts MODEL.PRETRAINED_CHECKPOINT weights.pth

VRL_FUSED_SCL=1 in the environment sends the SCL loss through the fused
CUDA kernels at any batch size (the default, auto, from 8192 frames a step;
0 never), as in the JAX package.

The flags are the root `train.py`'s, plus `--device` (default cuda). The
port's counterpart of that script. Data parallelism runs one process per
card, each started with the same flags and its own rank:

    python -m video_rep_learning_tpu_torch.train ... \
        --coordinator 127.0.0.1:29500 --num_processes 2 --process_id R

(rank R on card R % the cards, NCCL; gloo with `--device cpu`). A rank
that fails exits nonzero, and its peers fail at their next collective.
`main(argv)` returns the trainer.
"""

from __future__ import annotations

import os
import pprint
import random

import numpy as np

from .. import logging_utils
from ..evaluate import parse_cli
from ..evaluation.evaluate import make_trainer_evaluate_fn
from ..parallel import is_root_proc, process_group
from ..parser import load_config, setup_train_dir
from ..utils import SummaryWriter
from .trainer import Trainer

logger = logging_utils.get_logger(__name__)


def main(argv=None):
    args, device = parse_cli(argv)
    if device.type == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA device")
    with process_group(args.coordinator, args.num_processes, args.process_id,
                       device) as device:
        cfg = load_config(args)
        setup_train_dir(cfg, cfg.LOGDIR, args.continue_train, args.tempcfg)
        cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)

        random.seed(cfg.RNG_SEED)
        np.random.seed(cfg.RNG_SEED)
        logging_utils.setup_logging(cfg.LOGDIR)
        summary_writer = (SummaryWriter(os.path.join(cfg.LOGDIR, "train_logs"))
                          if is_root_proc() else None)
        logger.info("Train with config:")
        logger.info(pprint.pformat(cfg.to_plain()))

        trainer = Trainer(cfg, summary_writer=summary_writer, device=device)
        trainer.init_state()
        trainer.fit(evaluate_fn=make_trainer_evaluate_fn(summary_writer))
        if summary_writer is not None:
            summary_writer.close()
    return trainer
