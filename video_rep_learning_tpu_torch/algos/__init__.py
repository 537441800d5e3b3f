"""Algorithm registry (`algos/__init__.py:7-20`); SCL so far, the TCC, TCN
and classification algos come in a later slice."""

from __future__ import annotations

from .scl import SCL, scl_loss_dispatch, scl_sequence_loss  # noqa: F401

ALGO_REGISTRY = {"scl": SCL}


def get_algo(cfg):
    algo_name = cfg.TRAINING_ALGO
    if algo_name not in ALGO_REGISTRY:
        raise NotImplementedError(
            f"algorithm {algo_name} is not ported yet (have "
            f"{sorted(ALGO_REGISTRY)})")
    return ALGO_REGISTRY[algo_name](cfg)
