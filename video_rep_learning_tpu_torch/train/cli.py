"""Training on the GPU: CARL SCL with the port's kernels, auto-resuming
from the newest `LOGDIR/checkpoints/checkpoint_epoch_*.pth`, with the
downstream evaluation after the last epoch.

    python -m video_rep_learning_tpu_torch.train --workdir DATA_ROOT \\
        --cfg_file configs/scl_transformer_config.yml --logdir LOGDIR \\
        [--continue_train] [--device cuda] [--opts KEY VALUE ...]

The flags are the root `train.py`'s, plus `--device` (default cuda). The
port's counterpart of that script; single-process for now. `main(argv)`
returns the trainer.
"""

from __future__ import annotations

import os
import pprint
import random

import numpy as np

from .. import logging_utils
from ..evaluate import parse_cli
from ..evaluation.evaluate import make_trainer_evaluate_fn
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
    cfg = load_config(args)
    setup_train_dir(cfg, cfg.LOGDIR, args.continue_train, args.tempcfg)
    cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)

    random.seed(cfg.RNG_SEED)
    np.random.seed(cfg.RNG_SEED)
    logging_utils.setup_logging(cfg.LOGDIR)
    summary_writer = SummaryWriter(os.path.join(cfg.LOGDIR, "train_logs"))
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg.to_plain()))

    trainer = Trainer(cfg, summary_writer=summary_writer, device=device)
    trainer.init_state()
    trainer.fit(evaluate_fn=make_trainer_evaluate_fn(summary_writer))
    summary_writer.close()
    return trainer
