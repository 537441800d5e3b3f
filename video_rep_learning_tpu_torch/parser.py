"""CLI argument parsing and run-directory setup.

Mirrors the reference entry-point contract (`utils/parser.py:15-131`):
``--workdir --logdir --cfg_file --opts ... --continue_train --tempcfg``, the
EVAL batch/frames forced equal to TRAIN, and the "frozen config" semantics —
a ``config.yml`` snapshot written to LOGDIR on first run and *preferred over
the passed config* on restart unless ``--tempcfg``.

The port's own copy of `video_rep_learning_tpu/parser.py`, without the JAX
package's multi-host flags (`--coordinator --num_processes --process_id`):
the port's CLIs are single-process for now.
"""

from __future__ import annotations

import argparse
import os

from .config import ConfigNode, apply_opts, get_cfg, load_yaml_into
from .logging_utils import get_logger

logger = get_logger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Video representation learning (PyTorch port).")
    p.add_argument("--workdir", type=str, default="/tmp/datasets",
                   help="Path to datasets and pretrained models.")
    p.add_argument("--logdir", type=str, default=None, help="Path to logs.")
    p.add_argument("--continue_train", action="store_true", default=False,
                   help="Allow resuming into an existing logdir.")
    p.add_argument("--visualize", action="store_true", default=False)
    p.add_argument("--cfg_file", type=str, default=None, help="Path to the config file")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER,
                   help="Dotted KEY VALUE config overrides")
    p.add_argument("--tempcfg", action="store_true", default=False,
                   help="Ignore any frozen config.yml in logdir; use the passed config.")
    return p.parse_args(argv)


def load_config(args) -> ConfigNode:
    """Defaults <- YAML <- --opts, then logdir resolution and the EVAL=TRAIN
    batch/frame forcing (`utils/parser.py:64-96`)."""
    cfg = get_cfg()
    if args.cfg_file is not None and os.path.exists(args.cfg_file):
        logger.info("Using config from %s.", args.cfg_file)
        load_yaml_into(cfg, args.cfg_file)
    apply_opts(cfg, args.opts)

    if args.logdir is not None:
        cfg.LOGDIR = args.logdir
    else:
        cfg.LOGDIR = os.path.join("/tmp", cfg.LOGDIR.lstrip("/"))

    cfg.EVAL.BATCH_SIZE = cfg.TRAIN.BATCH_SIZE
    cfg.EVAL.NUM_FRAMES = cfg.TRAIN.NUM_FRAMES
    return cfg


def setup_train_dir(cfg: ConfigNode, logdir: str, continue_train: bool = False,
                    tempcfg: bool = False) -> None:
    """Create LOGDIR and freeze/restore ``config.yml`` (`utils/parser.py:106-131`)."""
    import yaml

    os.makedirs(logdir, exist_ok=True)
    config_path = os.path.join(logdir, "config.yml")
    if not os.path.exists(config_path):
        logger.info("Freezing config to %s", config_path)
        with open(config_path, "w") as f:
            f.write(cfg.to_yaml())
    elif tempcfg:
        logger.info("tempcfg mode enabled, ignoring existing config file")
    else:
        logger.info("Using frozen config from %s.", config_path)
        with open(config_path) as f:
            cfg.merge_from(yaml.safe_load(f))
    os.makedirs(os.path.join(logdir, "train_logs"), exist_ok=True)
