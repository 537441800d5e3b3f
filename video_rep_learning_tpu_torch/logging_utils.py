"""Rank-0 logging with the reference's stdout.log line format.

Counterpart of `video_rep_learning_tpu/logging_utils.py`, with the rank taken
from `torch.distributed` instead of JAX. The formatter string is a de-facto
API: `read_results.py` greps `metrics/all_*` lines out of `stdout.log`.
"""

from __future__ import annotations

import builtins
import logging
import os
import sys

_FORMATTER = logging.Formatter(
    "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
    datefmt="%m/%d %H:%M:%S",
)


def _is_root() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def setup_logging(output_dir: str | None = None) -> None:
    """Console + `LOGDIR/stdout.log` on rank 0; silence on other ranks."""
    root = logging.getLogger()
    root.handlers = []
    root.setLevel(logging.INFO)
    root.propagate = False

    if _is_root():
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.INFO)
        ch.setFormatter(_FORMATTER)
        root.addHandler(ch)
        if output_dir is not None:
            fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
            fh.setLevel(logging.INFO)
            fh.setFormatter(_FORMATTER)
            root.addHandler(fh)
    else:
        builtins.print = lambda *a, **k: None  # mirror reference print suppression


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
