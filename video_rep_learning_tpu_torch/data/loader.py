"""Host-side prefetching data loader.

The port's own copy of `video_rep_learning_tpu/data/loader.py`, so both
packages draw the same batches from the same seed. It stands in for torch
DataLoader + DistributedSampler (`datasets/__init__.py:9-117`): per-epoch
seeded shuffling, sharding across processes, drop_last batching, and
a background prefetch thread that overlaps FFmpeg decode (GIL-released C
calls) with device compute. Collation pads native-resolution frames onto the
dataset's canvas so every training step sees one shape.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from .datasets import VideoDataset


class DistributedSampler:
    """torch DistributedSampler parity: pad to a multiple of world size,
    shard round-robin, reshuffle per epoch from (seed, epoch)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-n // num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(self.n)
        else:
            idx = np.arange(self.n)
        total = self.num_samples * self.num_replicas
        if total > self.n:
            idx = np.concatenate([idx, idx[: total - self.n]])
        return idx[self.rank::self.num_replicas]


class ActionBatchSampler:
    """Per-batch single-action sampling for supervised TCC on PennAction
    (`penn_action.py:209-242`): every batch holds clips of one action,
    distributed-aware."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-len(dataset) // num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def batches(self) -> List[np.ndarray]:
        rng = np.random.RandomState(self.seed + self.epoch)
        out = []
        n_batches = self.num_samples // self.batch_size
        # action_to_indices is a list-of-lists indexed by action id
        # (`penn_action.py:52`); only actions present in this subset count
        pools = [np.asarray(p) for p in self.dataset.action_to_indices if len(p)]
        for _ in range(n_batches):
            pool = pools[rng.randint(len(pools))]
            out.append(pool[rng.randint(0, len(pool), self.batch_size)])
        return out


def collate(items: List[Dict], canvas=None) -> Dict:
    """Stack item dicts; pad 'videos' frames onto the (H, W) canvas."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key == "name":
            out["names"] = vals
            continue
        if key in ("videos", "video") and canvas is not None:
            vals = [_pad_to_canvas(v, canvas) for v in vals]
        if len(vals) == 1 and key in ("videos", "video"):
            # batch-1 fast path: a [None] view instead of np.stack's copy —
            # the item path is memcpy-bound (see Dataset._gather_views), and
            # batches are read-only from here (device_put next)
            out[key] = vals[0][None]
        else:
            out[key] = np.stack(vals)
    return out


def _pad_to_canvas(frames: np.ndarray, canvas) -> np.ndarray:
    """Pad (..., H, W, 3) uint8 frames to (..., Hc, Wc, 3); center-crop any
    oversize dimension (canvas probing is sampled, so rare outliers crop)."""
    Hc, Wc = canvas
    H, W = frames.shape[-3], frames.shape[-2]
    if H > Hc:
        off = (H - Hc) // 2
        frames = frames[..., off:off + Hc, :, :]
        H = Hc
    if W > Wc:
        off = (W - Wc) // 2
        frames = frames[..., :, off:off + Wc, :]
        W = Wc
    if H == Hc and W == Wc:
        return frames
    pad = [(0, 0)] * (frames.ndim - 3) + [(0, Hc - H), (0, Wc - W), (0, 0)]
    return np.pad(frames, pad)


class TrainLoader:
    """Iterates collated numpy batches with background prefetch.

    `ssl=True` yields the two-view contract; otherwise the single-clip
    supervised contract. RNG is derived per (seed, epoch, index) so items are
    reproducible regardless of thread scheduling."""

    def __init__(self, dataset: VideoDataset, batch_size: int, *,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0,
                 ssl: bool = True, prefetch: int = 2,
                 batch_sampler: Optional[ActionBatchSampler] = None,
                 pad_canvas: bool = True, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.ssl = ssl
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self.batch_sampler = batch_sampler
        self.sampler = DistributedSampler(len(dataset), num_replicas, rank,
                                          shuffle=True, seed=seed)
        self.epoch = 0
        self.canvas = dataset.canvas_size() if pad_canvas else None

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.sampler.set_epoch(epoch)
        if self.batch_sampler is not None:
            self.batch_sampler.set_epoch(epoch)

    def _batches(self) -> List[np.ndarray]:
        if self.batch_sampler is not None:
            return self.batch_sampler.batches()
        idx = self.sampler.indices()
        n_batches = len(idx) // self.batch_size  # drop_last=True
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_batches)]

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler.batches())
        return len(self.sampler.indices()) // self.batch_size

    def _make_item(self, index: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7919 + int(index)) % (2 ** 31))
        if self.ssl:
            return self.dataset.get_ssl_item(rng, int(index))
        return self.dataset.get_supervised_item(rng, int(index))

    def __iter__(self) -> Iterator[Dict]:
        """Batches decode on a pool of `num_workers` threads (the decoder's
        C FFmpeg calls release the GIL, so threads parallelize like the
        reference's NUM_WORKERS DataLoader processes) with a bounded window
        of in-flight batches; order and RNG are deterministic regardless of
        scheduling (per-index seeding)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        batches = self._batches()
        if self.num_workers == 1:
            # single-thread fallback: one producer thread, bounded queue
            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            stop = threading.Event()

            def producer():
                try:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = [self._make_item(i) for i in b]
                        q.put(collate(items, self.canvas))
                    q.put(None)
                except Exception as e:  # surface worker errors to the consumer
                    q.put(e)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
            return

        with ThreadPoolExecutor(self.num_workers) as ex:
            it = iter(batches)
            pending = deque()

            def submit_next():
                b = next(it, None)
                if b is None:
                    return False
                pending.append([ex.submit(self._make_item, i) for i in b])
                return True

            for _ in range(self.prefetch + 1):
                if not submit_next():
                    break
            while pending:
                futs = pending.popleft()
                items = [f.result() for f in futs]
                yield collate(items, self.canvas)
                submit_next()


class EvalLoader:
    """batch_size-1 full-video sweep loader (the reference's `emb_loader`s,
    `datasets/__init__.py:20-22`). Optionally sharded across processes for
    the FineGym distributed eval (`evaluate_finegym.py:156`)."""

    def __init__(self, dataset: VideoDataset, *, num_replicas: int = 1,
                 rank: int = 0, prefetch: int = 2, num_workers: int = 1):
        self.dataset = dataset
        self.sampler = DistributedSampler(len(dataset), num_replicas, rank,
                                          shuffle=False)
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))

    def __len__(self):
        return len(self.sampler.indices())

    def __iter__(self):
        indices = list(self.sampler.indices())
        if self.num_workers > 1:
            # parallel full-video decode; eval items are deterministic
            # (no RNG), so ordered futures preserve the sweep order
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as ex:
                it = iter(indices)
                pending = deque()

                def submit_next():
                    i = next(it, None)
                    if i is None:
                        return False
                    pending.append(ex.submit(self.dataset.get_eval_item, int(i)))
                    return True

                for _ in range(self.prefetch + 1):
                    if not submit_next():
                        break
                while pending:
                    yield pending.popleft().result()
                    submit_next()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer():
            try:
                for i in indices:
                    q.put(self.dataset.get_eval_item(int(i)))
                q.put(None)
            except Exception as e:
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
