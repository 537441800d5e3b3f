"""Metrics writer: TensorBoard when available, JSONL fallback (the port's
own copy of `video_rep_learning_tpu/utils/summary.py`).

Keeps the reference's two observability channels (SURVEY.md §5): TB event
files under LOGDIR/{train_logs,eval_logs} plus the parseable stdout.log
lines. When no TB backend is installed, scalars land in `scalars.jsonl`
(one JSON object per line) in the same directory so tooling still has a
machine-readable record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def add_image(self, tag: str, img, step: int, dataformats: str = "CHW"):
        if self._tb is not None:
            try:
                self._tb.add_image(tag, img, step, dataformats=dataformats)
            except Exception:
                pass
        # JSONL fallback skips images

    def add_video(self, tag: str, video, step: int, fps: int = 4):
        if self._tb is not None:
            try:
                import numpy as _np

                if isinstance(video, _np.ndarray):
                    import torch as _torch

                    video = _torch.from_numpy(_np.ascontiguousarray(video))
                self._tb.add_video(tag, video, step, fps=fps)
            except Exception:
                pass

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
