"""The FineGym evaluation harness: per-video embeddings on disk, then a
linear probe trained from scratch.

Counterpart of `video_rep_learning_tpu/evaluation/finegym.py` (reference
`evaluate_finegym.py:38-313`):
- every video's embeddings are pickled to LOGDIR/finegym_eval_{train,val}set
  as {"embs", "labels", "name"} (disk is the exchange medium: FineGym does
  not fit in memory), the name's `/` replaced by `_`; across processes each
  rank dumps its shard of the videos (rank 0 clears the directory first)
  and the ranks' file lists are gathered;
- the probe is a `Linear(EMBEDDING_SIZE, CLASS_NUM)` on the model's device,
  trained with SGD (momentum 0.9, weight decay 1e-6 added to the gradient
  before the momentum: optax's add_decayed_weights -> trace -> scale), the
  LR set each epoch to EVAL.CLASSIFICATION_LR * (1 + cos(pi e / E)) / 2 over
  E = EVAL.CLASSIFICATION_EPOCHS, on batches of 10 videos' frames (labels
  below 0 dropped) shuffled by `np.random.RandomState(RNG_SEED + epoch)`,
  then sharded over the ranks (padded to a multiple, JAX `:139-146`); the
  train set keeps max(10 x ranks, fraction x its videos) and drops its
  last partial batch, the val set keeps every video; the loss is the mean
  cross-entropy over a batch's frames, the accuracy counts every frame,
  its counters summed over the ranks;
- once per fraction of EVAL.CLASSIFICATION_FRACTIONS (fraction 1 alone for
  the classification algorithm), with the JAX package's log lines and
  `classification_{fraction}/{train,val}` scalars, which `read_results.py`
  greps.
The probe's initial weights are torch's Linear init seeded by RNG_SEED
(randomness does not cross from JAX); `train_linear_probe(init=...)` takes
given ones. As in the JAX package, each rank trains its own probe on its
shard and no gradient is averaged across ranks (JAX `probe_step` has no
pmean); the reference wraps its probe in DDP (ROADMAP queue 3).
DEBUG_USE_EXISTING_CACHE reuses the pickles of an earlier dump.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil

import numpy as np
import torch
import torch.nn.functional as F

from ..logging_utils import get_logger
from ..parallel import (all_gather_object, all_reduce_sum, is_root_proc,
                        synchronize, world)
from .embedding import iter_video_embeddings

logger = get_logger(__name__)

DEBUG_USE_EXISTING_CACHE = False
BATCH_VIDEOS = 10


def dump_embeddings_dataset(cfg, model, data_loader, output_dir, device):
    """Per-video embedding pickles in `output_dir`, one video at a time.
    Returns (file list, the UB_S1 one-set items (labels 74..88 of gym99) for
    visualization)."""
    os.makedirs(output_dir, exist_ok=True)
    files, oneset = [], []
    for rec in iter_video_embeddings(cfg, model, data_loader, device):
        embs, labels, name = rec["embs"], rec["labels"], rec["name"]
        path = os.path.join(output_dir, f"{str(name).replace('/', '_')}.pkl")
        # a padded shard gives one video to two ranks: each writes its own
        # file and renames it over the path
        tmp = f"{path}.{world()[1]}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"embs": embs, "labels": labels, "name": name}, f)
        os.replace(tmp, path)
        files.append(path)
        if cfg.EVAL.CLASS_NUM == 99 and len(labels) and 74 <= int(labels[0]) <= 88:
            oneset.append({"embs": embs, "labels": labels, "name": name})
    logger.info("dumped %d embedding files to %s", len(files), output_dir)
    return files, oneset


def _load_embedding_file(path):
    """(embs fp32, labels int64) of one pickle, frames labelled below 0 dropped."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    embs = np.asarray(data["embs"], np.float32)
    labels = np.asarray(data["labels"], np.int64)
    valid = labels >= 0
    return embs[valid], labels[valid]


def probe_batches(files, seed, shuffle, epoch, drop_last, num_replicas=1, rank=0):
    """Lists of file indices, BATCH_VIDEOS a batch, of rank `rank`'s shard:
    shuffled by RandomState(seed + epoch) when `shuffle`, padded with the
    first indices to a multiple of `num_replicas` and taken every
    `num_replicas`-th from `rank`; the last partial batch dropped with
    `drop_last`, kept otherwise."""
    idx = np.arange(len(files))
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    per = -(-len(idx) // num_replicas)
    idx = np.concatenate([idx, idx[:per * num_replicas - len(idx)]])[rank::num_replicas]
    stop = len(idx) - BATCH_VIDEOS + 1 if drop_last else len(idx)
    return [idx[s:s + BATCH_VIDEOS] for s in range(0, stop, BATCH_VIDEOS)]


def _batch(files, batch_idx, device):
    xs, ys = zip(*(_load_embedding_file(files[int(i)]) for i in batch_idx))
    return (torch.from_numpy(np.concatenate(xs)).to(device),
            torch.from_numpy(np.concatenate(ys)).to(device))


def train_linear_probe(cfg, train_files, val_files, fraction, cur_epoch,
                       summary_writer, device, init=None, probe_out=None):
    """Train the probe on `train_files` (its first max(10 x ranks, fraction
    x n)) and return its final val accuracy in percent, over every rank's
    shard. `init` = (weight (CLASS_NUM, EMBEDDING_SIZE), bias (CLASS_NUM,))
    arrays replaces the seeded init; a `probe_out` dict receives the
    trained Linear under "probe"."""
    device = torch.device(device)
    nproc, rank = world()
    lr0 = cfg.EVAL.CLASSIFICATION_LR
    total_e = cfg.EVAL.CLASSIFICATION_EPOCHS
    num_train = max(nproc * BATCH_VIDEOS, int(fraction * len(train_files)))
    train_files = train_files[:num_train]

    torch.manual_seed(cfg.RNG_SEED)
    probe = torch.nn.Linear(cfg.MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE,
                            cfg.EVAL.CLASS_NUM)
    if init is not None:
        with torch.no_grad():
            probe.weight.copy_(torch.as_tensor(np.array(init[0], np.float32)))
            probe.bias.copy_(torch.as_tensor(np.array(init[1], np.float32)))
    probe.to(device)
    opt = torch.optim.SGD(probe.parameters(), lr=lr0, momentum=0.9,
                          weight_decay=1e-6, dampening=0, nesterov=False)

    train_accuracy = accuracy = 0.0
    for e in range(total_e):
        for group in opt.param_groups:
            group["lr"] = lr0 * (1 + math.cos(math.pi * e / (1.0 * total_e))) / 2
        # correct counts stay on the device; read once an epoch
        correct, total = torch.zeros((), dtype=torch.int64, device=device), 0
        for b in probe_batches(train_files, cfg.RNG_SEED, True, e, True, nproc, rank):
            x, y = _batch(train_files, b, device)
            logits = probe(x)
            loss = F.cross_entropy(logits, y, reduction="sum") / max(len(y), 1)
            opt.zero_grad()
            loss.backward()
            opt.step()
            correct += (logits.detach().argmax(1) == y).sum()
            total += len(y)
        correct, total = all_reduce_sum(int(correct)), all_reduce_sum(total)
        train_accuracy = 100 * correct / max(total, 1)
        if e % 10 == 0:
            logger.info("[%d/%d] classification_%s train set: %.3f%% (%d/%d)",
                        e, total_e, fraction, train_accuracy, correct, total)

        correct, total = torch.zeros((), dtype=torch.int64, device=device), 0
        with torch.no_grad():
            for b in probe_batches(val_files, cfg.RNG_SEED, False, 0, False, nproc,
                                   rank):
                x, y = _batch(val_files, b, device)
                correct += (probe(x).argmax(1) == y).sum()
                total += len(y)
        correct, total = all_reduce_sum(int(correct)), all_reduce_sum(total)
        accuracy = 100 * correct / max(total, 1)
        if e % 10 == 0:
            logger.info("[%d/%d] classification_%s val set: %.3f%% (%d/%d)",
                        e, total_e, fraction, accuracy, correct, total)

    logger.info("classification_%s/train: %s", fraction, train_accuracy)
    logger.info("classification_%s/val: %s", fraction, accuracy)
    if summary_writer is not None:
        summary_writer.add_scalar(f"classification_{fraction}/train",
                                  train_accuracy, cur_epoch)
        summary_writer.add_scalar(f"classification_{fraction}/val",
                                  accuracy, cur_epoch)
    if probe_out is not None:
        probe_out["probe"] = probe
    return accuracy


def evaluate_loaders(cfg, model, train_loader, val_loader, cur_epoch,
                     summary_writer, device):
    """Dump both splits' embeddings (a fresh dump unless
    DEBUG_USE_EXISTING_CACHE; each rank its loader's shard, the file lists
    gathered), then run the probe once per fraction. Returns {fraction: val
    accuracy}, the same on every rank."""
    lists = {}
    for split, loader in (("train", train_loader), ("val", val_loader)):
        output_dir = os.path.join(cfg.LOGDIR, f"finegym_eval_{split}set")
        if is_root_proc():
            if DEBUG_USE_EXISTING_CACHE:
                print("WARNING: DEBUG_USE_EXISTING_CACHE, keeping cache in " + output_dir)
            elif os.path.exists(output_dir):
                shutil.rmtree(output_dir)
            os.makedirs(output_dir, exist_ok=True)
        synchronize()
        if DEBUG_USE_EXISTING_CACHE and os.listdir(output_dir):
            files = [os.path.join(output_dir, f) for f in os.listdir(output_dir)]
        else:
            logger.info("generating %s embeddings for finegym at %s (epoch %d)",
                        split, output_dir, cur_epoch)
            model.eval()
            files, _ = dump_embeddings_dataset(cfg, model, loader, output_dir, device)
            files = [f for sub in all_gather_object(files) for f in sub]
        lists[split] = sorted(files)

    fractions = cfg.EVAL.CLASSIFICATION_FRACTIONS
    if cfg.TRAINING_ALGO == "classification":
        fractions = [1]
    accs = {fraction: train_linear_probe(cfg, lists["train"], lists["val"], fraction,
                                         cur_epoch, summary_writer, device)
            for fraction in fractions}
    synchronize()
    return accs


def evaluate_once(trainer, cur_epoch, summary_writer):
    """The harness on a trainer's model and first embedding loaders."""
    return evaluate_loaders(trainer.cfg, trainer.model, trainer.train_emb_loader[0],
                            trainer.val_emb_loader[0], cur_epoch, summary_writer,
                            trainer.device)
