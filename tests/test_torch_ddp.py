"""The port's data-parallel training step against the JAX package's.

Two gloo ranks of the port (`tests/test_torch_parallel.py::run_ranks`),
each on its half of a global batch, against the JAX package's trainer on a
2-device mesh (`create_mesh(2)` under the 8-device conftest) over the whole
batch, as `tests/test_distributed.py` runs it. The same weights (the JAX
init, through `convert_to_carl_state_dict`), the same augmented views (both
trainers' augmentation bypassed), dropout off, SGD momentum, one step:
- SCL over the transformer with single_noself and batch_noself negatives,
  per rank (the reference's DDP; JAX's per-shard loss + pmean), and under
  VRL_GLOBAL_SCL=1 over the gathered global batch;
- TCC with 2 clips a rank (pairs per rank) and with 1 (the global pairs);
each with the loss (the ranks' mean), every parameter and every BN running
statistic after the step (layer4's and the head's train on the global
batch's statistics) at `tests/test_distributed.py`'s tolerances, and the
two ranks bit-identical."""

import os
from contextlib import contextmanager

import numpy as np
import pytest

import jax

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu.parallel.mesh import create_mesh, shard_batch
from video_rep_learning_tpu.train.optimizer import merge_params
from video_rep_learning_tpu.train.trainer import Trainer as JaxTrainer
from video_rep_learning_tpu_torch import config as port_config

from tests.test_torch_parallel import run_ranks

T, S, LR = 4, 32, 1e-3
LOSS_RTOL = 2e-5  # tests/test_distributed.py
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)

# (algo, global clips, SCL negatives, environment)
CASES = {
    "scl-single_noself": ("scl", 2, "single_noself", {}),
    "scl-batch_noself": ("scl", 2, "batch_noself", {}),
    "scl-batch_noself-global": ("scl", 2, "batch_noself", {"VRL_GLOBAL_SCL": "1"}),
    "tcc-2-a-rank": ("tcc", 4, "single_noself", {}),
    "tcc-1-a-rank": ("tcc", 2, "single_noself", {}),
}


def small_cfg(config_module, algo, clips, negative):
    cfg = config_module.get_cfg()
    cfg.IMAGE_SIZE = S
    cfg.TRAIN.NUM_FRAMES = cfg.EVAL.NUM_FRAMES = T
    cfg.TRAIN.BATCH_SIZE = clips
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 8
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS, e.HIDDEN_SIZE, e.D_FF, e.EMBEDDING_SIZE = 1, 32, 64, 16
    e.FC_LAYERS, e.CAPACITY_SCALAR, e.FC_DROPOUT_RATE = [[32, True]], 1, 0.0
    cfg.MODEL.PROJECTION_SIZE = 16
    cfg.DATA.NUM_WORKERS = 0
    cfg.TRAINING_ALGO = algo
    cfg.SSL = algo == "scl"
    cfg.SCL.NEGATIVE_TYPE = negative
    # SGD: the update is linear in the gradient (Adam's g / |g| would
    # magnify near-zero gradients' rounding)
    cfg.OPTIMIZER.TYPE = "MomentumOptimizer"
    cfg.USE_AMP = False
    return cfg


def make_batch(ssl, clips, seed=0):
    """Augmented views of differing colour and contrast (well-conditioned
    batch-statistic BNs), the last clip's last frame padding."""
    rng = np.random.RandomState(seed)
    lead = (clips, 2) if ssl else (clips,)
    videos = (rng.randn(*lead, T, S, S, 3) * rng.uniform(0.2, 2.0, lead + (T, 1, 1, 1))
              + rng.randn(*lead, T, 1, 1, 3) * 1.5).astype(np.float32)
    masks = np.ones(lead + (T,), np.float32)
    masks[-1, ..., -1] = 0
    steps = np.sort(np.stack([rng.choice(40, T, replace=False)
                              for _ in range(int(np.prod(lead)))]), axis=-1)
    return {"videos": videos, "video_masks": masks,
            "seq_lens": np.full(lead, 40, np.int32),
            "chosen_steps": steps.reshape(lead + (T,)).astype(np.int32)}


@contextmanager
def env_vars(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_dict(state):
    state = jax.device_get(state)
    return convert_to_carl_state_dict(merge_params(state["trainable"], state["frozen"]),
                                      state["batch_stats"], layer=3)


_JAX = {}


def jax_case(name):
    """The JAX trainer's step on a 2-device mesh: (initial weights, loss,
    weights and BN statistics after the step), in the reference layout;
    computed once a case."""
    if name not in _JAX:
        algo, clips, negative, env = CASES[name]
        cfg = small_cfg(jax_config, algo, clips, negative)
        batch = make_batch(cfg.SSL, clips)
        tr = JaxTrainer(cfg, no_eval=True, build_loaders=False, mesh=create_mesh(2))
        tr.init_state()
        before = reference_dict(tr.state)
        tr._augment_batch = lambda key, b: b["videos"]  # the views are given
        with env_vars(env):  # read while the step traces
            state, loss = tr.build_train_step()(tr.state, shard_batch(tr.mesh, batch),
                                                jax.random.key(0), 0, False, LR)
            loss = float(loss["loss"])
        _JAX[name] = (before, loss, reference_dict(state))
    return _JAX[name]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_jax_mesh(name, tmp_path):
    algo, clips, negative, env = CASES[name]
    before, want_loss, want = jax_case(name)
    cfg = small_cfg(port_config, algo, clips, negative)
    res = [r for _, _, r in run_ranks(
        "_rank_given_step", tmp_path, cfg=cfg.to_plain(), state=before,
        batch=make_batch(cfg.SSL, clips), lr=LR, env=env)]
    np.testing.assert_allclose(np.mean([r["loss"] for r in res]), want_loss,
                               rtol=LOSS_RTOL)
    got = res[0]["state"]
    moved = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):  # the JAX layout writes 0
            continue
        np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
        moved += not np.array_equal(v, before[k])
    assert moved > 20  # layer4, the head and its BN statistics all moved
    for k, v in got.items():  # one model on both ranks
        np.testing.assert_array_equal(res[1]["state"][k], v, err_msg=k)


def test_batch_noself_per_rank_and_global_negatives_differ():
    """Under batch_noself a rank's negatives are its own clips' other views,
    the global branch's every clip's: the two losses differ, so the cases
    above tell the branches apart."""
    per_rank, global_ = jax_case("scl-batch_noself")[1], jax_case("scl-batch_noself-global")[1]
    assert abs(per_rank - global_) > 1e-2 * abs(per_rank)
