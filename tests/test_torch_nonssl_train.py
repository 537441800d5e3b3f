"""The port's non-SSL training path and the supervised algorithms in the
trainer: one TCC step of a transformer CARL model against the JAX
package's (`TCC.compute_loss` + `jax.value_and_grad`) on the same weights
and the same augmented input, the loss and every head gradient; then a
whole `Trainer` epoch at 40 px over the synthetic Pouring set for (tcc,
transformer), (tcc, conv), (tcn, vanilla), (classification, transformer)
and TCC under SSL, each with its val epoch (classification's val "loss" is
its masked accuracy, in [0, 1])."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu.algos.tcc import TCC as JaxTCC
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu.train.optimizer import merge_params, split_params
from video_rep_learning_tpu_torch.algos import TCC
from video_rep_learning_tpu_torch.models import (build_model, set_trainable,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.train import Trainer

from tests.test_torch_model import init_jax_carl, small_carl_cfg

torch.set_num_threads(1)

T, S = 12, 32


def tcc_cfg():
    cfg = small_carl_cfg()
    cfg.SSL = False
    cfg.TRAINING_ALGO = "tcc"
    cfg.MODEL.PROJECTION = False
    cfg.MODEL.L2_NORMALIZE = False
    cfg.MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE = 0.0
    cfg.USE_AMP = False
    return cfg


@pytest.fixture(scope="module")
def jax_tcc_step():
    """The JAX package's TCC loss and gradients of the trainable parameters
    on a pre-augmented batch of 2 clips, in the reference layout."""
    cfg = tcc_cfg()
    rng = np.random.RandomState(0)
    x = rng.rand(1, T, S, S, 3).astype(np.float32)
    jmodel, variables = init_jax_carl(cfg, x)
    sd = convert_to_carl_state_dict(variables["params"], variables["batch_stats"],
                                    layer=3)
    # frames that differ in colour and contrast (as `test_torch_train.py`)
    videos = (rng.randn(2, T, S, S, 3) * rng.uniform(0.2, 2.0, (2, T, 1, 1, 1))
              + rng.randn(2, T, 1, 1, 3) * 1.5).astype(np.float32)
    masks = np.ones((2, T), np.float32)
    masks[1, -3:] = 0
    batch = {"videos": videos, "video_masks": masks,
             "seq_lens": np.array([40, 31], np.int32),
             "chosen_steps": np.stack([np.sort(rng.choice(n, T, replace=False))
                                       for n in (40, 31)]).astype(np.int32)}
    trainable, frozen = split_params(variables["params"], cfg)

    def loss_fn(tr):
        v = {"params": merge_params(tr, frozen), "batch_stats": variables["batch_stats"]}
        loss, _ = JaxTCC(cfg).compute_loss(
            jmodel, v, {k: jnp.asarray(a) for k, a in batch.items()}, train=True,
            rngs={"dropout": jax.random.key(0)})
        return loss["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    zeros = {k: np.zeros_like(v) for k, v in frozen.items()}
    grad_sd = convert_to_carl_state_dict(
        traverse_util.unflatten_dict({**grads, **zeros}), variables["batch_stats"],
        layer=3)
    return cfg, sd, batch, float(loss), grad_sd


def test_tcc_training_step_matches_jax(jax_tcc_step):
    cfg, sd, batch, ref_loss, grad_sd = jax_tcc_step
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_numpy(sd), strict=True)
    set_trainable(model, cfg.MODEL.TRAIN_BASE)
    model.train()
    loss = TCC(cfg).compute_loss(model, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})["loss"]
    loss.backward()
    # fp32 through the frozen trunk, layer4 and the head, summed in another
    # order: 1e-5 of the loss (as the SCL step of `test_torch_train.py`)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    heads = 0
    for n, p in model.named_parameters():
        if p.grad is None:
            assert not np.any(grad_sd[n]), n
            continue
        heads += n.startswith("embed.")
        # as `test_torch_train.py`: gradients through the batch-statistic
        # BNs, each tensor to 1e-4 of its largest value (at least 1)
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
    assert heads > 0


# -- a Trainer epoch of each supervised path --------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    root = tmp_path_factory.mktemp("torch_nonssl")
    make_pouring(str(root / "pouring"), num_train=4, num_val=2, min_len=20,
                 max_len=30, size=40, seed=0)
    return root


def epoch_cfg(root, logdir, algo, embedder, ssl=False):
    cfg = small_carl_cfg()
    cfg.PATH_TO_DATASET = str(root / "pouring")
    cfg.LOGDIR = logdir
    cfg.TRAINING_ALGO = algo
    cfg.SSL = ssl
    cfg.TRAIN.BATCH_SIZE = 2
    # TCC pairs the clips of a batch: a val batch of one clip raises, in
    # both packages (the shipped configs' EVAL.BATCH_SIZE is 1)
    cfg.EVAL.BATCH_SIZE = 2
    cfg.TRAIN.NUM_FRAMES = 6
    cfg.IMAGE_SIZE = 40
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 24
    cfg.MODEL.EMBEDDER_TYPE = embedder
    cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS = 1
    cfg.MODEL.PROJECTION = ssl
    cfg.MODEL.L2_NORMALIZE = algo != "tcc"
    cfg.DATA.SAMPLING_STRATEGY = "offset_uniform"
    cfg.DATA.NUM_WORKERS = 0
    cfg.USE_AMP = False
    if embedder == "conv":  # the layer3 grid is 3x3 at 40 px
        cfg.MODEL.EMBEDDER_MODEL.CONV_LAYERS = [[8, 1, 0]]
        cfg.MODEL.TRAIN_BASE = "train_all"
        cfg.DATA.NUM_CONTEXTS = 2
        cfg.DATA.CONTEXT_STRIDE = 3
    return cfg


@pytest.mark.parametrize("algo,embedder,ssl", [
    ("tcc", "transformer", False), ("tcc", "conv", False), ("tcn", "vanilla", False),
    ("classification", "transformer", False), ("tcc", "transformer", True)],
    ids=["tcc_transformer", "tcc_conv", "tcn_vanilla", "classification", "ssl_tcc"])
def test_supervised_trainer_epoch(synth, tmp_path, algo, embedder, ssl):
    cfg = epoch_cfg(synth, str(tmp_path), algo, embedder, ssl)
    tr = Trainer(cfg, device="cpu")
    names = {n for n, p in tr.model.named_parameters() if p.requires_grad}
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    assert any(n.startswith("classifier.") for n in names) == (algo == "classification")
    assert any(n.startswith("backbone.") for n in names) == (embedder == "conv")
    loss = tr.train_one_epoch(0)["loss"]
    assert np.isfinite(loss) and loss != 0.0
    moved = {n for n, p in tr.model.named_parameters() if not torch.equal(p, before[n])}
    assert moved and moved <= names
    val = tr.val_one_epoch(0)["loss"]
    assert np.isfinite(val)
    if algo == "classification":
        assert 0.0 <= val <= 1.0
