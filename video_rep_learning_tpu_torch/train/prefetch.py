"""The trainer's device prefetch (DATA.DEVICE_PREFETCH = d > 0).

Counterpart of `video_rep_learning_tpu/train/trainer.py::_batch_stream`: a
worker thread iterates the train loader and copies each batch to the device
while the loop steps the one before, `d` batches ahead at most (a d-deep
queue). On a card a batch's arrays go through pinned host buffers, one a
key reused from batch to batch (the worker waits for each copy to finish,
so a buffer is free again when the next batch comes), onto the device with
`non_blocking=True` on a copy stream of the prefetcher's own. The consumer
makes its compute stream wait for that copy and hands each tensor to the
caching allocator as used on the compute stream (`record_stream`), so a
freed batch's memory is not given to the next copy while the step still
reads it. The worker runs under `torch.cuda.device` of the trainer's card
(a thread starts on card 0). A pinning or stream failure raises: the
prefetch never falls back to the serial copy. On the CPU the thread and
the queue stay, with neither streams nor pinning.

A loader's exception surfaces in the consumer. Leaving the stream early
(a `break`, an exception in the step, KeyboardInterrupt) stops the worker
and joins it, draining the queue as the JAX package does; the caller
closes the stream (`contextlib.closing`) so that this happens at once, and
no thread outlives the epoch. Batches before `skip_until` (a mid-epoch
resume) are yielded without being copied.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

THREAD_NAME = "h2d-prefetch"
_END = object()


class DevicePrefetcher:
    """Copies the loader's batches to `device` on a worker thread.
    `to_device(batch)` is the serial copy of the same arrays (the trainer's
    `device_batch`), taken as it is on the CPU; `keys` are the batch's
    arrays the step reads on the device."""

    def __init__(self, device, depth: int, keys: Tuple[str, ...],
                 to_device: Callable[[Dict], Dict]):
        if depth <= 0:
            raise ValueError(f"a prefetch depth of {depth}: depth 0 is the serial loop")
        self.device = torch.device(device)
        self.depth = depth
        self.keys = keys
        self.to_device = to_device
        self.cuda = self.device.type == "cuda"
        self.copy_stream: Optional[torch.cuda.Stream] = None
        self._pinned: Dict[str, torch.Tensor] = {}  # flat uint8, grown on demand
        self.h2d_events = []  # (start, end) on the copy stream, the last epoch's
        if self.cuda:
            with torch.cuda.device(self.device):
                self.copy_stream = torch.cuda.Stream(self.device)

    # -- the worker's side --------------------------------------------------

    def _pinned_view(self, key: str, arr: np.ndarray) -> torch.Tensor:
        """`arr` copied into this key's pinned buffer, as a tensor of its
        shape and dtype."""
        src = torch.as_tensor(arr)
        nbytes = src.numel() * src.element_size()
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = self._pinned[key] = torch.empty(nbytes, dtype=torch.uint8,
                                                  pin_memory=True)
        view = buf[:nbytes].view(src.dtype).view(src.shape)
        view.copy_(src)
        return view

    def _copy(self, batch) -> Tuple[Dict, Optional[torch.cuda.Event]]:
        """The batch's arrays on the device, and the copy stream's event
        after them (None on the CPU)."""
        if not self.cuda:
            return self.to_device(batch), None
        pinned = {k: self._pinned_view(k, np.ascontiguousarray(batch[k]))
                  for k in ("videos",) + self.keys if k in batch}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record()
            dev = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            done.record()
        done.synchronize()  # the pinned buffers are free again; marker 1 is the copy
        self.h2d_events.append((start, done))
        return dev, done

    def _work(self, loader, q: queue.Queue, stop: threading.Event, skip_until: int):
        try:
            with torch.cuda.device(self.device) if self.cuda else nullcontext():
                for it, batch in enumerate(loader):
                    if stop.is_set():
                        break
                    if it < skip_until:  # a resumed epoch: consumed, not copied
                        q.put((it, None, None, None, 0.0))
                        continue
                    t0 = time.time()
                    dev, event = self._copy(batch)
                    host = {k: v for k, v in batch.items() if k != "videos"}
                    q.put((it, host, dev, event, time.time() - t0))
            q.put(_END)
        except BaseException as e:  # surfaced to the consumer
            q.put(e)

    # -- the consumer's side ------------------------------------------------

    def stream(self, loader, skip_until: int = 0) -> Iterator[Tuple[int, Dict, Dict, float]]:
        """Yields (iteration, host batch without "videos", device batch,
        H2D seconds) in loader order; before `skip_until`, (iteration,
        None, None, 0.0)."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        self.h2d_events = []
        th = threading.Thread(target=self._work, args=(loader, q, stop, skip_until),
                              daemon=True, name=THREAD_NAME)
        th.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                it, host, dev, event, h2d_s = item
                if event is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(event)
                    for t in dev.values():
                        t.record_stream(compute)
                yield it, host, dev, h2d_s
        finally:
            stop.set()
            while th.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=0.05)

    def h2d_ms(self):
        """The copy stream's ms of each batch copied in the last stream, from
        pinned memory to the device (CUDA events; [] on the CPU)."""
        return [s.elapsed_time(e) for s, e in self.h2d_events]
