"""Dataloader factory (`datasets/__init__.py:9-117`).

The port's own copy of `video_rep_learning_tpu/data/__init__.py`; the
process rank comes from `torch.distributed` instead of JAX.

construct_dataloader(cfg, split) -> (loader, emb_loader_list):
- pouring:  Pouring train/val loader + one sample_all emb loader
- finegym:  FineGym loaders, emb loaders sharded across processes
            (distributed FineGym eval path)
- kinetics400: K400 train loader; emb loaders come from the remaining
            DATASETS entries (PennAction), mirroring the reference's
            DATASETS[1:] pop (`datasets/__init__.py:46-55`)
- else:     PennAction (full for train; 13 per-action emb loaders);
            ActionBatchSampler for supervised TCC
"""

from __future__ import annotations

import numpy as np

from ..config import ConfigNode
from .datasets import FineGym, Kinetics400, PennAction, Pouring, VideoDataset  # noqa: F401
from .loader import (ActionBatchSampler, DistributedSampler, EvalLoader,  # noqa: F401
                     TrainLoader, collate)
from .samplers import sample_all_frames, sample_frames  # noqa: F401
from .splits import DATASET_TO_NUM_CLASSES, DATASETS, PENN_ACTION_LIST  # noqa: F401

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _dist_info():
    """(world size, rank) of an initialised `torch.distributed` group, else
    (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def construct_dataloader(cfg: ConfigNode, split: str, mode: str = "auto",
                         no_eval: bool = False):
    assert split in ("train", "val", "test")
    nrep, rank = _dist_info()
    seed = cfg.RNG_SEED
    ssl = bool(cfg.SSL)
    batch_size = cfg.TRAIN.BATCH_SIZE if split == "train" else cfg.EVAL.BATCH_SIZE
    primary = cfg.DATASETS[0]

    if primary == "pouring":
        ds = Pouring(cfg, split, mode="train" if split == "train" else mode)
        loader = TrainLoader(ds, batch_size, num_replicas=nrep, rank=rank,
                             seed=seed, ssl=ssl,
                             num_workers=cfg.DATA.NUM_WORKERS)
        emb_ds = Pouring(cfg, split, mode="eval", sample_all=True)
        emb_loaders = [EvalLoader(emb_ds, num_workers=cfg.DATA.NUM_WORKERS)]
    elif primary == "finegym":
        ds = FineGym(cfg, split, mode="train" if split == "train" else mode)
        loader = TrainLoader(ds, batch_size, num_replicas=nrep, rank=rank,
                             seed=seed, ssl=ssl,
                             num_workers=cfg.DATA.NUM_WORKERS)
        emb_ds = FineGym(cfg, split, mode="eval", sample_all=True,
                         entries=ds.entries)
        emb_loaders = [EvalLoader(emb_ds, num_replicas=nrep, rank=rank,
                                  num_workers=cfg.DATA.NUM_WORKERS)]
    elif primary == "kinetics400":
        ds = Kinetics400(cfg, "train")
        loader = TrainLoader(ds, batch_size, num_replicas=nrep, rank=rank,
                             seed=seed, ssl=ssl,
                             num_workers=cfg.DATA.NUM_WORKERS)
        if no_eval:
            emb_loaders = None
        else:
            cfg.DATASETS = cfg.DATASETS[1:]  # `datasets/__init__.py:48`
            emb_loaders = [
                EvalLoader(PennAction(cfg, split, name, mode="eval", sample_all=True),
                       num_workers=cfg.DATA.NUM_WORKERS)
                for name in cfg.DATASETS]
    else:
        ds = PennAction(cfg, split, mode="train" if split == "train" else "eval")
        batch_sampler = None
        if not cfg.SSL and "tcc" in cfg.TRAINING_ALGO:
            batch_sampler = ActionBatchSampler(ds, batch_size, nrep, rank, seed)
        loader = TrainLoader(ds, batch_size, num_replicas=nrep, rank=rank,
                             seed=seed, ssl=ssl,
                             num_workers=cfg.DATA.NUM_WORKERS, batch_sampler=batch_sampler)
        emb_loaders = [
            EvalLoader(PennAction(cfg, split, name, mode="eval", sample_all=True),
                       num_workers=cfg.DATA.NUM_WORKERS)
            for name in cfg.DATASETS]
    return loader, emb_loaders


def unnorm(images, mean=IMAGENET_MEAN, stddev=IMAGENET_STD):
    """Inverse ImageNet normalization for logging (`datasets/__init__.py:119-143`)."""
    images = np.asarray(images)
    mean = np.asarray(mean).reshape(1, -1, 1, 1)
    std = np.asarray(stddev).reshape(1, -1, 1, 1)
    return np.clip(images * std + mean, 0.0, 1.0)
