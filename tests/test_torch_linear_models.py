"""The port's own linear probes (`evaluation/linear_models.py`, numpy +
scipy) against the sklearn estimators the JAX package fits, and the
classification and event-completion tasks built on them against the JAX
package's tasks on the same embeddings; then the options the port does not
carry out yet, which raise where the config is read.

Tolerances:
- logistic regression: the same objective and the same L-BFGS-B options,
  from zeros; sklearn sums its loss in the embeddings' float32 where the
  port sums in float64, so the optima differ by rounding: coefficients
  within 1e-3 of their largest value (measured ~4e-7), predictions and
  accuracy identical;
- least squares: the same centred `lstsq` in float64: 1e-8;
- the tasks: accuracy is a count of argmax decisions, which the rounding
  above does not flip on this data (identical); the event-completion R^2
  is continuous, and sklearn solves it in the embeddings' float32: 1e-5.
"""

import numpy as np
import pytest
import torch
from sklearn.linear_model import LinearRegression as SkLinearRegression
from sklearn.linear_model import LogisticRegression as SkLogisticRegression

from video_rep_learning_tpu.config import get_cfg as jax_get_cfg
from video_rep_learning_tpu.evaluation.classification import \
    Classification as JaxClassification
from video_rep_learning_tpu.evaluation.event_completion import \
    EventCompletion as JaxEventCompletion
from video_rep_learning_tpu_torch.config import get_cfg
from video_rep_learning_tpu_torch.evaluation.classification import Classification
from video_rep_learning_tpu_torch.evaluation.event_completion import EventCompletion
from video_rep_learning_tpu_torch.evaluation.linear_models import (
    LeastSquares, LogisticRegression)
from video_rep_learning_tpu_torch.models.carl import resolve_model_spec
from video_rep_learning_tpu_torch.train import Trainer

torch.set_num_threads(1)


def _embeddings(rng, n, d, k):
    """Unit-norm float32 embeddings of k noisy clusters, as the model's."""
    labels = rng.randint(0, k, n)
    x = rng.randn(k, d)[labels] + 1.5 * rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), labels


@pytest.mark.parametrize("classes", [3, 5, 2])
def test_logistic_regression_matches_sklearn(classes):
    rng = np.random.RandomState(classes)
    x, y = _embeddings(rng, 300, 16, classes)
    xv, yv = _embeddings(rng, 120, 16, classes)
    want = SkLogisticRegression(max_iter=100000, solver="lbfgs").fit(x, y)
    got = LogisticRegression(max_iter=100000).fit(x, y)
    assert got.coef_.shape == want.coef_.shape
    scale = np.abs(want.coef_).max()
    assert np.abs(got.coef_ - want.coef_).max() <= 1e-3 * scale
    assert np.abs(got.intercept_ - want.intercept_).max() <= 1e-3 * scale
    for a, b in ((x, y), (xv, yv)):
        np.testing.assert_array_equal(got.predict(a), want.predict(a))
        assert got.score(a, b) == want.score(a, b)


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_least_squares_matches_sklearn(rank_deficient):
    rng = np.random.RandomState(1)
    x = rng.randn(200, 12)
    if rank_deficient:  # a repeated column: lstsq's minimum-norm solution
        x[:, 5] = x[:, 4]
    y = x[:, :3] @ rng.randn(3, 3) + 0.3 * rng.randn(200, 3) + 2.0
    got = LeastSquares().fit(x, y)
    want = [SkLinearRegression().fit(x, y[:, i]) for i in range(3)]
    for i, est in enumerate(want):
        np.testing.assert_allclose(got.coef_[:, i], est.coef_, atol=1e-8)
        np.testing.assert_allclose(got.intercept_[i], est.intercept_, atol=1e-8)
    xv = rng.randn(50, 12)
    yv = xv[:, :3] + rng.randn(50, 3)
    for a, b in ((x, y), (xv, yv)):
        want_r2 = np.mean([est.score(a, b[:, i]) for i, est in enumerate(want)])
        assert abs(got.score(a, b) - want_r2) <= 1e-8


def _task_dataset(rng):
    """Pouring-like videos (5 phases in order) with embeddings that drift
    along the phases: 6 train and 4 val videos."""
    def split(n_videos):
        embs, labels = [], []
        for _ in range(n_videos):
            n = rng.randint(40, 70)
            cuts = np.sort(rng.choice(np.arange(5, n - 5), 4, replace=False))
            lab = np.searchsorted(cuts, np.arange(n), side="right")
            e = (np.linspace(0, 3, n)[:, None] * rng.randn(1, 16)
                 + 0.7 * rng.randn(n, 16))
            embs.append((e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32))
            labels.append(lab)
        return {"embs": embs, "labels": labels}
    return {"name": "pouring", "train_dataset": split(6), "val_dataset": split(4)}


@pytest.mark.parametrize("task", ["classification", "event_completion"])
def test_tasks_match_jax_package(task):
    dataset = _task_dataset(np.random.RandomState(7))
    port, jax_task = {"classification": (Classification, JaxClassification),
                      "event_completion": (EventCompletion, JaxEventCompletion)}[task]
    got = port(get_cfg()).evaluate(dataset, 0, None)
    want = jax_task(jax_get_cfg()).evaluate(dataset, 0, None)
    if task == "classification":
        assert got == want
    else:
        assert abs(got - want) <= 1e-5


def test_remat_over_resnet_tail_raises():
    cfg = get_cfg()
    cfg.MODEL.REMAT = True  # LAYER 3: layer4 is the trainable tail
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        resolve_model_spec(cfg)


def test_mid_epoch_checkpoints_raise():
    """Mid-epoch checkpoints no longer raise (ROADMAP queue 1 item 5 is
    ported, tests/test_torch_mid_checkpoint.py), nor does the FineGym
    harness across processes (item 6, tests/test_torch_finegym.py); what
    still raises where the trainer reads the config is tensor parallelism,
    item 6b."""
    cfg = get_cfg()
    cfg.CHECKPOINT.SAVE_EVERY_N_ITERS = 10
    tr = Trainer(cfg, build_loaders=False, device="cpu")
    assert tr.start_iter == 0 and tr.cfg.CHECKPOINT.SAVE_EVERY_N_ITERS == 10
    cfg.PARALLEL.TENSOR_PARALLELISM = 2
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        Trainer(cfg, build_loaders=False, device="cpu")
