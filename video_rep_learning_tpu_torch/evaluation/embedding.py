"""Embedding extraction: the per-video sweep through the model.

Counterpart of `video_rep_learning_tpu/evaluation/embedding.py`
(`iter_video_embeddings`, `get_embeddings_dataset`, `_record`), following
the reference rule: batch-size-1 videos split into ceil(len / FRAMES_PER_BATCH)
chunks of equal size, each embedded without the projection head (so the
embeddings are the L2-normalised representation), frames with label < 0
dropped.

PyTorch runs each chunk at its exact length, so the JAX package's padded
buckets (`bucket_size`, there for XLA's static shapes) are not carried over.
Frames go to the device as uint8 and are preprocessed there. The sweep runs
under inference mode, so a partially frozen ViT's front and back end both
run without grad (no kernel saves anything for a backward). A finished
video's embeddings stay on the device until the next video's work has been
queued (the one-record holdback), so the copy back to the host does not stall
the device between videos. With DATA.NUM_CONTEXTS n > 1 (the conv and
vanilla embedders) each step of a chunk brings its n context frames,
CONTEXT_STRIDE * (-(n-1) .. 0) from it, clipped to the video, steps-major
as the training sampler lays them out; the chunk runs at its exact length,
no frame masked. The frame-packed sweep (`_iter_frameflat`) and
EVAL.PACK_VIDEOS (which raises) come in a later slice.
"""

from __future__ import annotations

import math
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


def iter_video_embeddings(cfg, model, data_loader, device):
    """Yield one record per video of `data_loader` (items as
    `EvalLoader` gives them), in loader order."""
    if int(cfg.EVAL.PACK_VIDEOS) > 1:
        raise NotImplementedError(
            "EVAL.PACK_VIDEOS > 1 (the frame-packed sweep) comes with ROADMAP "
            "queue 1 item 7")
    max_fpb = cfg.EVAL.FRAMES_PER_BATCH
    num_contexts = int(cfg.DATA.NUM_CONTEXTS)
    ctx = cfg.DATA.CONTEXT_STRIDE * np.arange(-(num_contexts - 1), 1)
    prev = None
    for item in data_loader:
        seq_len = int(item["seq_len"])
        if item["video"].shape[0] != seq_len:
            raise ValueError(f"video {item['name']} has {item['video'].shape[0]}"
                             f" frames, seq_len {seq_len}")
        num_batches = int(math.ceil(float(seq_len) / max_fpb))
        frames_per_batch = int(math.ceil(float(seq_len) / num_batches))
        dims = tuple(float(d) for d in item["dims"])
        with torch.inference_mode():
            video = torch.as_tensor(np.array(item["video"]), device=device)
            if num_contexts != 1:  # each step's context frames, steps-major
                steps = np.clip(np.arange(seq_len)[:, None] + ctx[None, :], 0,
                                seq_len - 1)
                video = video[torch.as_tensor(steps.reshape(-1), device=device)]
            span = frames_per_batch * num_contexts
            embs = [embed_chunk(cfg, model, video[i:i + span], dims)
                    for i in range(0, seq_len * num_contexts, span)]
        if prev is not None:
            yield _materialize(prev)
        prev = (item, embs)
    if prev is not None:
        yield _materialize(prev)


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
