"""Downstream evaluation: extract train and val embeddings per dataset, run
every embedding task, log `metrics/{dataset}_{task}` and the
`metrics/all_{task}` averages in sorted task order.

Counterpart of `video_rep_learning_tpu/evaluation/evaluate.py::evaluate_once`
with the same log lines (`read_results.py` greps them). The model carries its
weights, so there is no `variables` argument; `device` is where it runs.
A FineGym run (DATASETS[0] finegym) goes to the FineGym harness
(`evaluation/finegym.py`) instead, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

from ..logging_utils import get_logger
from .embedding import get_embeddings_dataset

logger = get_logger(__name__)


def evaluate_once(cfg, model, train_emb_loaders, val_emb_loaders,
                  iterator_tasks, embedding_tasks, cur_epoch, summary_writer,
                  device) -> Dict[str, Dict[str, float]]:
    metrics: Dict[str, Dict[str, float]] = {}

    if embedding_tasks:
        for i, dataset_name in enumerate(cfg.DATASETS):
            dataset = {"name": dataset_name}
            logger.info("generating train embeddings for %s dataset at %d.",
                        dataset_name, cur_epoch)
            dataset["train_dataset"] = get_embeddings_dataset(
                cfg, model, train_emb_loaders[i], device)
            logger.info("generating val embeddings for %s dataset at %d.",
                        dataset_name, cur_epoch)
            dataset["val_dataset"] = get_embeddings_dataset(
                cfg, model, val_emb_loaders[i], device)

            for task_name, task in embedding_tasks.items():
                metrics.setdefault(task_name, {})
                metrics[task_name][dataset_name] = task.evaluate(
                    dataset, cur_epoch, summary_writer)
            del dataset

    for task_name in sorted(embedding_tasks.keys()):
        for dataset_name in cfg.DATASETS:
            if summary_writer is not None:
                summary_writer.add_scalar(
                    "metrics/%s_%s" % (dataset_name, task_name),
                    metrics[task_name][dataset_name], cur_epoch)
        avg_metric = sum(metrics[task_name].values()) / len(cfg.DATASETS)
        logger.info("metrics/all_%s: %.4f", task_name, avg_metric)
        if summary_writer is not None:
            summary_writer.add_scalar("metrics/all_%s" % task_name,
                                      avg_metric, cur_epoch)
    return metrics


def make_trainer_evaluate_fn(summary_writer):
    """Adapter for `Trainer.fit(evaluate_fn=...)`: runs `evaluate_once` (or
    the FineGym harness) on the trainer's model and embedding loaders
    (`train.py:327-334`). Across processes the FineGym harness runs on every
    rank; the other tasks on rank 0 alone (their loaders are not sharded),
    the other ranks waiting at a barrier (JAX `evaluation/evaluate.py:60-80`).
    Returns the metrics, None on the ranks that waited."""
    from ..parallel import is_root_proc, synchronize
    from . import get_tasks

    def fn(trainer, epoch):
        if trainer.cfg.DATASETS[0] == "finegym":
            from .finegym import evaluate_once as fg_evaluate_once

            return fg_evaluate_once(trainer, epoch, summary_writer)
        metrics = None
        if is_root_proc():
            iterator_tasks, embedding_tasks = get_tasks(trainer.cfg)
            trainer.model.eval()
            metrics = evaluate_once(trainer.cfg, trainer.model, trainer.train_emb_loader,
                                    trainer.val_emb_loader, iterator_tasks,
                                    embedding_tasks, epoch, summary_writer,
                                    trainer.device)
        synchronize()
        return metrics

    return fn
