"""Algorithm registry (`algos/__init__.py:7-20`): SCL, TCC, TCN and the
supervised per-frame classification."""

from __future__ import annotations

from .classification import Classification, classification_loss  # noqa: F401
from .scl import SCL, scl_loss_dispatch, scl_sequence_loss  # noqa: F401
from .tcc import TCC, tcc_loss  # noqa: F401
from .tcn import TCN, tcn_loss  # noqa: F401

ALGO_REGISTRY = {
    "classification": Classification,
    "tcc": TCC,
    "tcn": TCN,
    "scl": SCL,
}


def get_algo(cfg):
    algo_name = cfg.TRAINING_ALGO
    if algo_name not in ALGO_REGISTRY:
        raise ValueError(f"Algorithm {algo_name} not supported "
                         f"(choose from {sorted(ALGO_REGISTRY)})")
    return ALGO_REGISTRY[algo_name](cfg)
