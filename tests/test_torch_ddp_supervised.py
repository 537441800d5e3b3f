"""TCN and classification across two ranks against the JAX package's
2-device mesh.

The JAX package runs both under plain `jit` over the sharded global batch,
so its loss is one over the global batch. Two gloo ranks of the port
(`tests/test_torch_parallel.py::run_ranks`, `_rank_given_step`), each on
its half of the batch, against the JAX trainer on `create_mesh(2)`, as
`tests/test_torch_ddp.py` runs SCL and TCC (its config, weights and
tolerances: loss rtol 2e-5, every parameter and BN statistic rtol 1e-4 /
atol 1e-6, the ranks bit-identical):
- TCN, one clip a rank: a mean of equal-size per-clip means, which the
  ranks' average already is;
- classification with the ranks' valid frames (mask 1 and label >= 0)
  equal, and unequal (8 against 2): each rank divides its masked sum by
  the ranks' summed count. A mean of per-rank masked means, the form
  before this change, gives another loss and gradient in the unequal case
  (checked on the ranks' own numbers).
"""

import jax
import numpy as np
import pytest

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from video_rep_learning_tpu.train.trainer import Trainer as JaxTrainer
from video_rep_learning_tpu_torch import config as port_config

from tests.test_torch_ddp import (LOSS_RTOL, LR, PARAM_TOL, T, make_batch,
                                  reference_dict, small_cfg)
from tests.test_torch_parallel import run_ranks

# (algo, global clips, frames without a valid label on each rank's clips)
CASES = {
    "tcn": ("tcn", 2, None),
    "classification-equal": ("classification", 4, ((1, 0), (0, 1))),
    "classification-unequal": ("classification", 4, ((0, 0), (3, 3))),
}


def supervised_batch(algo, clips, dropped):
    """`make_batch`'s views with labels in [0, 2); for classification,
    clip c of the global batch has `dropped` frames masked out or labelled
    -1 (alternately), so the ranks' valid-frame counts are as given."""
    batch = make_batch(False, clips)
    rng = np.random.RandomState(1)
    batch["labels"] = rng.randint(0, 2, (clips, T)).astype(np.int32)
    batch["video_masks"][:] = 1.0
    if dropped is not None:
        for c, n in enumerate(d for rank in dropped for d in rank):
            for k in range(n):
                if k % 2:
                    batch["labels"][c, T - 1 - k] = -1
                else:
                    batch["video_masks"][c, T - 1 - k] = 0.0
    return batch


def valid_counts(batch, world=2):
    w = batch["video_masks"] * (batch["labels"] >= 0)
    return w.reshape(world, -1).sum(axis=1)


_JAX = {}
_STEPS = {}


def jax_case(name):
    """(initial weights, loss, weights and BN statistics after one step) of
    the JAX trainer on a 2-device mesh, in the reference layout; the two
    classification cases share one trainer and its compiled step."""
    if name not in _JAX:
        algo, clips, dropped = CASES[name]
        if (algo, clips) not in _STEPS:
            cfg = small_cfg(jax_config, algo, clips, "single_noself")
            tr = JaxTrainer(cfg, no_eval=True, build_loaders=False, mesh=create_mesh(2))
            tr.init_state()
            tr._augment_batch = lambda key, b: b["videos"]  # the views are given
            _STEPS[algo, clips] = (tr, jax.device_get(tr.state), tr.build_train_step())
        tr, init, step = _STEPS[algo, clips]
        batch = supervised_batch(algo, clips, dropped)
        # the step donates the state it is given: each case gets a copy
        state, loss = step(replicate(tr.mesh, init), shard_batch(tr.mesh, batch),
                           jax.random.key(0), 0, False, LR)
        _JAX[name] = (reference_dict(init), float(loss["loss"]), reference_dict(state))
    return _JAX[name]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_supervised_step_matches_jax_mesh(name, tmp_path):
    algo, clips, dropped = CASES[name]
    before, want_loss, want = jax_case(name)
    cfg = small_cfg(port_config, algo, clips, "single_noself")
    batch = supervised_batch(algo, clips, dropped)
    res = [r for _, _, r in run_ranks("_rank_given_step", tmp_path, cfg=cfg.to_plain(),
                                      state=before, batch=batch, lr=LR)]
    losses = np.array([r["loss"] for r in res])
    np.testing.assert_allclose(losses.mean(), want_loss, rtol=LOSS_RTOL)
    if dropped is not None:
        counts = valid_counts(batch)
        assert (counts[0] == counts[1]) == (name == "classification-equal")
        # the mean of per-rank masked means (each rank's own count): rank r
        # returned 2 * sum_r / (c_0 + c_1), so its own mean is that x
        # (c_0 + c_1) / (2 c_r)
        per_rank_means = losses * counts.sum() / (2 * counts)
        off = abs(per_rank_means.mean() - want_loss) / abs(want_loss)
        assert (off > 100 * LOSS_RTOL) == (name == "classification-unequal"), off
    got = res[0]["state"]
    moved = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):  # the JAX layout writes 0
            continue
        np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
        moved += not np.array_equal(v, before[k])
    assert moved > 20  # layer4, the head and its BN statistics all moved
    if algo == "classification":
        assert any(k.startswith("classifier.") and not np.array_equal(want[k], before[k])
                   for k in want)
    for k, v in got.items():  # one model on both ranks
        np.testing.assert_array_equal(res[1]["state"][k], v, err_msg=k)
