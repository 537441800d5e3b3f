"""Embedding extraction: the sweeps through the model.

Counterpart of `video_rep_learning_tpu/evaluation/embedding.py`
(`iter_video_embeddings` with its three sweeps, `get_embeddings_dataset`,
`_record`), following the reference rule: batch-size-1 videos split into
ceil(len / FRAMES_PER_BATCH) chunks of equal size, each embedded without
the projection head (so the embeddings are the L2-normalised
representation), frames with label < 0 dropped.

PyTorch runs each chunk at its exact length, so the JAX package's padded
buckets (`bucket_size`, there for XLA's static shapes) are not carried over.
Frames go to the device as uint8 (or are there already) and are
preprocessed there. The sweeps run under inference mode, so a partially
frozen ViT's front and back end both run without grad (no kernel saves
anything for a backward). A finished video's embeddings stay on the device
until the next video's work has been queued (the one-record holdback), so
the copy back to the host does not stall the device between videos.

The sweeps (`iter_video_embeddings`, as JAX `:387-416` without its TPU
default):
- per-video: each chunk through the whole model. With DATA.NUM_CONTEXTS
  n > 1 (the conv and vanilla embedders) each step of a chunk brings its n
  context frames, CONTEXT_STRIDE * (-(n-1) .. 0) from it, clipped to the
  video, steps-major as the training sampler lays them out;
- frame-packed (`_iter_frameflat`; VRL_EVAL_FLAT=1, or EVAL.FLAT_EXTRACT
  with VRL_EVAL_FLAT unset or auto; NUM_CONTEXTS 1 and a transformer
  embedder): the per-frame trunk (`backbone_flat`) runs on blocks of FB
  frames that cross video boundaries, and a video's head (`head_embs`) runs
  on its chunks as soon as its last frame has been through the trunk. The
  last block and the head chunks run at their exact lengths, so the head
  sees what the per-video sweep gives it;
- packed (`_iter_packed`; EVAL.PACK_VIDEOS = P > 1, NUM_CONTEXTS 1): a
  window of 2P videos at a time; its chunks sorted by length, in groups of
  up to P, each group one forward padded to its longest chunk by repeating
  the last frame, with a key mask and a true length a chunk.
Each gives the per-video sweep's embeddings up to the order of sums.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from ..logging_utils import get_logger
from ..ops.augment import eval_augment

logger = get_logger(__name__)


def embed_chunk(cfg, model, frames, dims):
    """(n, H, W, 3) uint8 frames on the model's device, n = steps x
    DATA.NUM_CONTEXTS -> (steps, emb) fp32 embeddings of one chunk,
    positions taken from its true length n."""
    video = eval_augment(frames.float() / 255.0, cfg.IMAGE_SIZE, dims=dims)
    n = video.shape[0]
    num_frames = n // max(int(cfg.DATA.NUM_CONTEXTS), 1)
    return model(video[None], num_frames, project=False, true_seq_len=n)[0]


def _record(item, embs):
    labels = np.asarray(item["labels"])
    valid = labels >= 0
    return {"embs": embs[valid], "labels": labels[valid],
            "seq_len": int(item["seq_len"]),
            "input_len": item["video"].shape[0],
            "steps": np.asarray(item["chosen_steps"]), "name": item["name"]}


def _materialize(dev_rec):
    item, embs = dev_rec
    with torch.inference_mode():
        embs = torch.cat(embs).cpu().numpy()
    return _record(item, embs)


def _video(item, device):
    """An item's (T, H, W, 3) uint8 frames on `device`, checked against its
    seq_len; a video already on the device (a benchmark's staged set) is
    taken as it is."""
    video = item["video"]
    seq_len = int(item["seq_len"])
    if video.shape[0] != seq_len:
        raise ValueError(f"video {item['name']} has {video.shape[0]} frames, "
                         f"seq_len {seq_len}")
    if isinstance(video, torch.Tensor):
        return video.to(device)
    return torch.as_tensor(np.array(video), device=device)


def _chunks(seq_len: int, max_fpb: int):
    """The reference's chunking (`evaluate.py:44-63`): (start, length) of
    ceil(len / max) chunks of equal size, the last one shorter."""
    num_batches = int(math.ceil(float(seq_len) / max_fpb))
    frames_per_batch = int(math.ceil(float(seq_len) / num_batches))
    return [(i, min(seq_len - i, frames_per_batch))
            for i in range(0, seq_len, frames_per_batch)]


def _dims(item):
    return tuple(float(d) for d in item["dims"])


def eval_sweep(cfg, model) -> str:
    """Which sweep `iter_video_embeddings` runs: "flat", "packed" or
    "per_video" (JAX `embedding.py:397-416`, without its TPU default)."""
    contexts = int(cfg.DATA.NUM_CONTEXTS)
    env = os.environ.get("VRL_EVAL_FLAT", "auto")
    if env not in ("0", "1", "auto"):
        raise ValueError(f"VRL_EVAL_FLAT={env!r}: 0, 1 or auto")
    flat = bool(cfg.EVAL.FLAT_EXTRACT) if env == "auto" else env == "1"
    if flat and contexts == 1 and model.spec.embedder_type == "transformer":
        return "flat"
    if int(cfg.EVAL.PACK_VIDEOS or 1) > 1 and contexts == 1:
        return "packed"
    return "per_video"


def flat_block(cfg, model) -> int:
    """FB, the frames of a trunk block: EVAL.FLAT_BLOCK, else
    VRL_EVAL_FLAT_BLOCK, else min(FRAMES_PER_BATCH, 256 for a ResNet, 128
    for a ViT) (JAX `embedding.py:216-224`)."""
    default = 256 if model.spec.vit_spec is None else 128
    return (int(cfg.EVAL.FLAT_BLOCK or 0)
            or int(os.environ.get("VRL_EVAL_FLAT_BLOCK", 0))
            or min(int(cfg.EVAL.FRAMES_PER_BATCH), default))


def iter_video_embeddings(cfg, model, data_loader, device):
    """Yield one record per video of `data_loader` (items as
    `EvalLoader` gives them), in loader order, from the sweep `eval_sweep`
    picks."""
    sweep = eval_sweep(cfg, model)
    if sweep == "flat":
        yield from _iter_frameflat(cfg, model, data_loader, device)
        return
    if sweep == "packed":
        yield from _iter_packed(cfg, model, data_loader, device,
                                int(cfg.EVAL.PACK_VIDEOS))
        return
    max_fpb = cfg.EVAL.FRAMES_PER_BATCH
    num_contexts = int(cfg.DATA.NUM_CONTEXTS)
    ctx = cfg.DATA.CONTEXT_STRIDE * np.arange(-(num_contexts - 1), 1)
    prev = None
    for item in data_loader:
        seq_len = int(item["seq_len"])
        dims = _dims(item)
        with torch.inference_mode():
            video = _video(item, device)
            if num_contexts != 1:  # each step's context frames, steps-major
                steps = np.clip(np.arange(seq_len)[:, None] + ctx[None, :], 0,
                                seq_len - 1)
                video = video[torch.as_tensor(steps.reshape(-1), device=device)]
            embs = [embed_chunk(cfg, model, video[i * num_contexts:(i + n) * num_contexts],
                                dims)
                    for i, n in _chunks(seq_len, max_fpb)]
        if prev is not None:
            yield _materialize(prev)
        prev = (item, embs)
    if prev is not None:
        yield _materialize(prev)


def _iter_frameflat(cfg, model, data_loader, device):
    """The frame-packed sweep (JAX `embedding.py:198-328`): each video's
    augmented frames queue in loader order; a trunk block runs as soon as
    FB frames are queued (splitting a video where the block ends), its rows
    go back to their videos, and a video whose last frame has been through
    the trunk runs its head on the reference's chunks. The dataset's last
    block is shorter; nothing is padded."""
    max_fpb = cfg.EVAL.FRAMES_PER_BATCH
    FB = flat_block(cfg, model)
    needs_cls = model.spec.vit_spec is not None
    # videos in loader order: [item, feature rows, CLS rows, frames to go];
    # a finished one becomes None (the indices stay)
    pending = []
    next_yield = 0
    queued, queued_frames = [], 0  # (augmented frames, video index)

    def head(item, feats, cls):
        feats = feats[0] if len(feats) == 1 else torch.cat(feats)
        if needs_cls:
            cls = cls[0] if len(cls) == 1 else torch.cat(cls)
        embs = []
        for i, n in _chunks(int(item["seq_len"]), max_fpb):
            out = model.head_embs(feats[None, i:i + n], cls[i:i + n] if needs_cls else None,
                                  n, project=False, true_seq_len=n)
            embs.append(out[0])
        return item, embs

    def drain(final=False):
        """Run the trunk on every full block queued (and on the rest when
        `final`); return the videos finished in loader order, headed."""
        nonlocal queued_frames, next_yield
        done = []
        while queued_frames >= FB or (final and queued_frames > 0):
            take, got = [], 0
            while got < FB and queued:
                seg, vi = queued.pop(0)
                if seg.shape[0] > FB - got:
                    queued.insert(0, (seg[FB - got:], vi))
                    seg = seg[:FB - got]
                take.append((seg, vi))
                got += seg.shape[0]
            queued_frames -= got
            block = take[0][0] if len(take) == 1 else torch.cat([s for s, _ in take])
            feats, cls = model.backbone_flat(block)
            off = 0
            for seg, vi in take:
                m = seg.shape[0]
                pending[vi][1].append(feats[off:off + m])
                if needs_cls:
                    pending[vi][2].append(cls[off:off + m])
                pending[vi][3] -= m
                off += m
            while next_yield < len(pending) and pending[next_yield][3] == 0:
                item, fs, cs, _ = pending[next_yield]
                pending[next_yield] = None
                next_yield += 1
                done.append(head(item, fs, cs))
        return done

    def records():
        nonlocal queued_frames
        for item in data_loader:
            with torch.inference_mode():
                video = _video(item, device)
                aug = eval_augment(video.float() / 255.0, cfg.IMAGE_SIZE,
                                   dims=_dims(item))
                pending.append([item, [], [], aug.shape[0]])
                queued.append((aug, len(pending) - 1))
                queued_frames += aug.shape[0]
                done = drain()
            yield from done
        with torch.inference_mode():
            done = drain(final=True)
        yield from done
        if next_yield != len(pending):
            raise AssertionError("the flat sweep left videos without embeddings")

    prev = None
    for rec in records():
        if prev is not None:
            yield _materialize(prev)
        prev = rec
    if prev is not None:
        yield _materialize(prev)


def _iter_packed(cfg, model, data_loader, device, pack: int):
    """The packed sweep (JAX `embedding.py:331-384`): a window of 2P videos
    at a time, their chunks sorted by length and taken in groups of up to P,
    each group one forward of (G, L) frames, L its longest chunk, the
    shorter ones padded by repeating their last frame, with the key mask
    `video_masks` (G, 1, L) and each chunk's true length. Records come in
    loader order, a window at a time."""
    max_fpb = cfg.EVAL.FRAMES_PER_BATCH

    def run_window(items):
        chunks, outs = [], []  # (video, chunk, augmented frames); embeddings
        with torch.inference_mode():
            for vi, item in enumerate(items):
                video, dims = _video(item, device), _dims(item)
                spans = _chunks(int(item["seq_len"]), max_fpb)
                outs.append([None] * len(spans))
                chunks += [(vi, ci, eval_augment(video[i:i + n].float() / 255.0,
                                                 cfg.IMAGE_SIZE, dims=dims))
                           for ci, (i, n) in enumerate(spans)]
            chunks.sort(key=lambda c: -c[2].shape[0])  # stable: loader order in a length
            for g in range(0, len(chunks), pack):
                group = chunks[g:g + pack]
                L = group[0][2].shape[0]
                frames = torch.stack([
                    torch.cat([aug, aug[-1:].expand((L - aug.shape[0],) + aug.shape[1:])])
                    for _, _, aug in group])
                lens = torch.tensor([aug.shape[0] for _, _, aug in group],
                                    device=frames.device)
                masks = (torch.arange(L, device=frames.device)[None] < lens[:, None])
                out = model(frames, L, video_masks=masks.float()[:, None], project=False,
                            true_seq_len=lens)
                for j, (vi, ci, aug) in enumerate(group):
                    outs[vi][ci] = out[j, :aug.shape[0]]
        for item, embs in zip(items, outs):
            yield _materialize((item, embs))

    window = []
    for item in data_loader:
        window.append(item)
        if len(window) == 2 * pack:
            yield from run_window(window)
            window = []
    if window:
        yield from run_window(window)


def get_embeddings_dataset(cfg, model, data_loader, device) -> Dict:
    """One full pass over an eval loader."""
    dataset = {"embs": [], "labels": [], "seq_lens": [], "input_lens": [],
               "steps": [], "names": []}
    for rec in iter_video_embeddings(cfg, model, data_loader, device):
        dataset["embs"].append(rec["embs"])
        dataset["labels"].append(rec["labels"])
        dataset["seq_lens"].append(rec["seq_len"])
        dataset["input_lens"].append(rec["input_len"])
        dataset["steps"].append(rec["steps"])
        dataset["names"].append(rec["name"])
    logger.info("embeddings_dataset size: %d", len(dataset["embs"]))
    return dataset
