"""The port's TCC, TCN and classification losses against the JAX package's
on the same seeded numpy inputs: the loss and its gradient with respect to
the embeddings (`jax.grad` against autograd), every TCC loss type x
similarity x NORMALIZE_INDICES with label smoothing, TCN's n-pairs loss,
classification in training (cross-entropy) and eval (masked accuracy) with
-1 labels and masks; TCC refuses a batch of one sequence."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_rep_learning_tpu.algos.classification import \
    classification_loss as jax_classification_loss
from video_rep_learning_tpu.algos.tcc import tcc_loss as jax_tcc_loss
from video_rep_learning_tpu.algos.tcn import tcn_loss as jax_tcn_loss
from video_rep_learning_tpu_torch.algos import (classification_loss, tcc_loss,
                                                tcn_loss)

torch.set_num_threads(1)

# fp32 on both sides, the products at full fp32 precision (Precision.HIGHEST
# in JAX, no TF32 here): the same math summed in another order
RTOL, ATOL = 1e-5, 1e-6
B, T, C = 3, 10, 8

LOSS_TYPES = ["classification", "regression_mse", "regression_mse_var",
              "regression_huber"]


def _tcc_inputs(seed):
    rng = np.random.RandomState(seed)
    embs = rng.randn(B, T, C).astype(np.float32)
    seq_lens = rng.randint(T, 4 * T, B).astype(np.int32)
    steps = np.stack([np.sort(rng.choice(n, T, replace=False))
                      for n in seq_lens]).astype(np.int32)
    return embs, seq_lens, steps


def _grad_check(port_fn, jax_fn, embs):
    ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(embs))
    te = torch.from_numpy(embs).requires_grad_()
    loss = port_fn(te)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=RTOL, atol=ATOL)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(te.grad.numpy(), ref_g, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(ref_g).max()))


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw_steps"])
@pytest.mark.parametrize("similarity", ["l2", "cosine"])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_tcc_loss_and_gradient_match_jax(loss_type, similarity, normalize):
    embs, seq_lens, steps = _tcc_inputs(0)
    embs = embs / np.linalg.norm(embs, axis=-1, keepdims=True)  # norm 1
    kw = dict(loss_type=loss_type, similarity_type=similarity, temperature=0.1,
              label_smoothing=0.1, variance_lambda=0.001, huber_delta=0.1,
              normalize_indices=normalize)
    _grad_check(
        lambda e: tcc_loss(e, torch.from_numpy(seq_lens), torch.from_numpy(steps),
                           **kw)["loss"],
        lambda e: jax_tcc_loss(e, jnp.asarray(seq_lens), jnp.asarray(steps),
                               **kw)["loss"], embs)


def test_tcc_var_extras_match_jax():
    embs, seq_lens, steps = _tcc_inputs(1)
    embs = embs / np.linalg.norm(embs, axis=-1, keepdims=True)
    kw = dict(loss_type="regression_mse_var", similarity_type="l2",
              temperature=0.1, label_smoothing=0.0, variance_lambda=0.001,
              huber_delta=0.1, normalize_indices=True)
    ref = jax_tcc_loss(jnp.asarray(embs), jnp.asarray(seq_lens),
                       jnp.asarray(steps), **kw)
    got = tcc_loss(torch.from_numpy(embs), torch.from_numpy(seq_lens),
                   torch.from_numpy(steps), **kw)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_tcc_refuses_one_sequence():
    embs, seq_lens, steps = _tcc_inputs(2)
    with pytest.raises(ValueError, match="at least 2"):
        tcc_loss(torch.from_numpy(embs[:1]), torch.from_numpy(seq_lens[:1]),
                 torch.from_numpy(steps[:1]), loss_type="regression_mse_var",
                 similarity_type="l2", temperature=0.1, label_smoothing=0.1,
                 variance_lambda=0.001, huber_delta=0.1, normalize_indices=True)


@pytest.mark.parametrize("reg_lambda", [0.002, 0.5])
def test_tcn_loss_and_gradient_match_jax(reg_lambda):
    embs = np.random.RandomState(3).randn(B, 2 * T, C).astype(np.float32)
    _grad_check(lambda e: tcn_loss(e, reg_lambda=reg_lambda)["loss"],
                lambda e: jax_tcn_loss(e, reg_lambda=reg_lambda)["loss"], embs)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_classification_loss_matches_jax(training):
    rng = np.random.RandomState(4)
    K = 5
    logits = rng.randn(B, T, K).astype(np.float32)
    labels = rng.randint(-1, K, (B, T)).astype(np.int32)  # -1: no label
    masks = np.ones((B, T), np.float32)
    masks[1, -4:] = 0  # a padded tail
    lab, msk = torch.from_numpy(labels), torch.from_numpy(masks)
    if training:
        _grad_check(lambda x: classification_loss(x, lab, msk, True)["loss"],
                    lambda x: jax_classification_loss(
                        x, jnp.asarray(labels), jnp.asarray(masks), True)["loss"],
                    logits)
    else:
        got = classification_loss(torch.from_numpy(logits), lab, msk, False)["loss"]
        ref = jax_classification_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(masks), False)["loss"]
        assert 0.0 <= got.item() <= 1.0
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
