"""Evaluation task registry: the four embedding tasks and `get_tasks`.

Counterpart of `video_rep_learning_tpu/evaluation/__init__.py`. Neither
importing this package nor running its four tasks needs JAX or sklearn
(the linear probes are `linear_models.py`'s). FineGym runs the harness of
`finegym.py` in place of the tasks.
"""

from __future__ import annotations

from .classification import Classification
from .embedding import get_embeddings_dataset  # noqa: F401
from .event_completion import EventCompletion
from .kendalls_tau import KendallsTau
from .retrieval import Retrieval

TASK_REGISTRY = {
    "kendalls_tau": KendallsTau,
    "retrieval": Retrieval,
    "classification": Classification,
    "event_completion": EventCompletion,
}


def get_tasks(cfg):
    """Split configured tasks into iterator and embedding tasks by their
    `downstream_task` flag (all four built-ins are embedding tasks)."""
    iterator_tasks, embedding_tasks = {}, {}
    for name in cfg.EVAL.TASKS:
        if name not in TASK_REGISTRY:
            raise ValueError(f"Unknown eval task {name}")
        task = TASK_REGISTRY[name](cfg)
        if getattr(task, "downstream_task", False):
            embedding_tasks[name] = task
        else:
            iterator_tasks[name] = task
    return iterator_tasks, embedding_tasks
