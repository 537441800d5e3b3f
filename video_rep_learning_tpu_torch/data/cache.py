"""Process-wide decoded-frame host-RAM cache (the port's own copy of
`video_rep_learning_tpu/data/cache.py`).

The reference re-decodes every sampled frame range each epoch through its
DataLoader workers (`datasets/pouring.py:83`), and one host core decodes
far fewer frames per second than a training step consumes. Small datasets' decoded
working sets fit host RAM trivially (Pouring: tens of videos), so this cache
decodes each video ONCE per process (full-video sequential decode — faster
per frame than ranged seeks) and serves every later range as a numpy slice,
making training decode-free after the first epoch.

Enabled by `DATA.DECODE_CACHE_MB` (default 0 = off, exact reference
semantics) or the `VRL_DECODE_CACHE_MB` env override. Bit-safety: a ranged
H.264 decode seeks to a keyframe and decodes forward to `start`, producing
the same pixels as the sequential full-video decode at that index
(`tests/test_data.py::test_decode_cache_bit_identical`), so training batches
are unchanged with the cache on.

Budget semantics: videos are admitted whole until the budget is full (the
training working set is either fully resident or the dataset is too big to
bother — no LRU churn); an estimated-oversize video is rejected up front
without wasting a full decode.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Set

import numpy as np

from ..logging_utils import get_logger

logger = get_logger(__name__)


def range_from_full(full: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Slice [start, stop) from a fully decoded video, replicating the
    decoder's EOF padding (repeat the last frame) when stop overruns."""
    n = full.shape[0]
    stop_c = min(stop, n)
    out = np.ascontiguousarray(full[start:stop_c])
    if stop_c < stop:
        out = np.concatenate(
            [out, np.repeat(out[-1:], stop - stop_c, axis=0)], axis=0)
    return out


class DecodeCache:
    """Thread-safe whole-video cache with a global byte budget."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.used = 0
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._videos: Dict[str, np.ndarray] = {}
        self._inflight: Dict[str, threading.Event] = {}
        self._rejected: Set[str] = set()

    def get_full(self, path: str,
                 decode_all: Callable[[], np.ndarray],
                 est_bytes: Optional[int] = None) -> Optional[np.ndarray]:
        """The cached full video, decoding it on first access. Returns None
        when the video doesn't fit the remaining budget (callers fall back to
        a ranged decode). Concurrent first accesses decode once: the loser
        waits on the winner's event instead of duplicating the work."""
        while True:
            with self._lock:
                vid = self._videos.get(path)
                if vid is not None:
                    self.hits += 1
                    return vid
                if path in self._rejected:
                    self.misses += 1
                    return None
                ev = self._inflight.get(path)
                if ev is None:
                    if est_bytes is not None and (
                            self.used + est_bytes > self.budget):
                        self._rejected.add(path)
                        self.misses += 1
                        return None
                    ev = threading.Event()
                    self._inflight[path] = ev
                    break  # this thread decodes
            ev.wait()

        try:
            video = decode_all()
        except BaseException:
            with self._lock:
                self._rejected.add(path)
                del self._inflight[path]
            ev.set()
            raise
        with self._lock:
            if self.used + video.nbytes > self.budget:
                self._rejected.add(path)
                self.misses += 1
                result = None
            else:
                self._videos[path] = video
                self.used += video.nbytes
                result = video
            del self._inflight[path]
        ev.set()
        return result

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"videos": len(self._videos), "bytes": self.used,
                    "hits": self.hits, "misses": self.misses,
                    "rejected": len(self._rejected)}


_GLOBAL: Optional[DecodeCache] = None
_GLOBAL_LOCK = threading.Lock()


def get_decode_cache(cfg=None) -> Optional[DecodeCache]:
    """The process-wide cache, sized from `VRL_DECODE_CACHE_MB` (wins) or
    `cfg.DATA.DECODE_CACHE_MB`. None when the budget is 0 (default). The
    singleton grows to the largest budget requested so train and eval
    dataset objects over the same files share one pool."""
    global _GLOBAL
    env = os.environ.get("VRL_DECODE_CACHE_MB")
    if env is not None:
        mb = float(env)
    elif cfg is not None:
        mb = float(cfg.get_path("DATA.DECODE_CACHE_MB", 0) or 0)
    else:
        mb = 0.0
    if mb <= 0:
        return None
    budget = int(mb * 1024 * 1024)
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            logger.info("decoded-frame cache enabled: %d MB budget", mb)
            _GLOBAL = DecodeCache(budget)
        elif budget > _GLOBAL.budget:
            logger.info("decoded-frame cache budget grown to %.0f MB", mb)
            _GLOBAL.budget = budget
        return _GLOBAL


def reset_decode_cache():
    """Testing hook: drop the singleton (and its memory)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
