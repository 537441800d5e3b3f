"""The port's training pieces against the JAX package's: the SCL loss and its
gradient, the optimizer chain and LR schedule against optax, one whole
training step of the CARL model (loss, gradients, updated parameters and BN
statistics) against `SCL.compute_loss` + `jax.value_and_grad` +
`make_optimizer`, and checkpoint save -> resume."""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu.algos.scl import SCL as JaxSCL
from video_rep_learning_tpu.algos.scl import scl_sequence_loss as jax_scl
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu.train.optimizer import learning_rate_for_epoch as jax_lr
from video_rep_learning_tpu.train.optimizer import (make_optimizer, merge_params,
                                                    split_params)
from video_rep_learning_tpu_torch.algos import SCL, scl_sequence_loss
from video_rep_learning_tpu_torch.models import (build_model, set_trainable,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.train import Optimizer, learning_rate_for_epoch

from tests.test_torch_model import init_jax_carl, small_carl_cfg

torch.set_num_threads(1)

NEGATIVE_TYPES = ["single_noself", "batch_noself", "single", "batch"]


def _scl_inputs(seed, B=2, V=2, T=10, C=16):
    rng = np.random.RandomState(seed)
    e = rng.randn(B, V, T, C).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    seq_lens = rng.randint(T, 3 * T, (B, V)).astype(np.int32)
    steps = np.sort(rng.randint(0, T, (B, V, T)), axis=-1).astype(np.int32)
    masks = np.ones((B, V, T), np.float32)
    masks[0, 1, -3:] = 0  # a padded view tail
    return e, seq_lens, steps, masks


@pytest.mark.parametrize("negative_type", NEGATIVE_TYPES)
def test_scl_loss_and_gradient_match_jax(negative_type):
    e, seq_lens, steps, masks = _scl_inputs(0)
    kw = dict(temperature=0.1, label_varience=10.0, positive_type="gauss",
              negative_type=negative_type)
    ref, ref_g = jax.value_and_grad(
        lambda x: jax_scl(x, jnp.asarray(seq_lens), jnp.asarray(steps),
                          jnp.asarray(masks), **kw)["loss"])(jnp.asarray(e))
    te = torch.from_numpy(e).requires_grad_()
    loss = scl_sequence_loss(te, torch.from_numpy(seq_lens),
                             torch.from_numpy(steps), torch.from_numpy(masks),
                             **kw)["loss"]
    loss.backward()
    # fp32 on both sides: exp / log / xlogy over a (40, 40) matrix summed in
    # another order
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ref_g), atol=1e-5)


def _opt_cfg(opt_type, decay, clip):
    cfg = small_carl_cfg()
    cfg.OPTIMIZER.TYPE = opt_type
    cfg.OPTIMIZER.GRAD_CLIP = clip
    cfg.OPTIMIZER.WEIGHT_DECAY = 1e-2
    cfg.OPTIMIZER.LR.DECAY_TYPE = decay
    cfg.OPTIMIZER.LR.NUM_WARMUP_STEPS = 2
    cfg.OPTIMIZER.LR.WARMUP_LR = 1e-5
    cfg.TRAIN.MAX_EPOCHS = 6
    return cfg


@pytest.mark.parametrize("decay", ["fixed", "cosine", "cosinewarmup", "multiply"])
def test_learning_rate_schedule_matches_jax(decay):
    cfg = _opt_cfg("AdamOptimizer", decay, 10)
    for epoch in range(8):
        assert learning_rate_for_epoch(cfg, epoch) == jax_lr(cfg, epoch)


@pytest.mark.parametrize("clip", [0.5, 0], ids=["clipped", "noclip"])
@pytest.mark.parametrize("opt_type", ["AdamOptimizer", "MomentumOptimizer",
                                      "AdamWOptimizer"])
def test_optimizer_matches_optax(opt_type, clip):
    """Four steps with new gradients each step and the per-epoch LR, against
    `make_optimizer`'s optax chain; with clip 0.5 the global norm (~3)
    triggers the clip on every step."""
    cfg = _opt_cfg(opt_type, "cosine", clip)
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    tx = make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in params.items()]
    opt = Optimizer(tp, cfg)
    for step in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        lr = learning_rate_for_epoch(cfg, step)
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        up, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp:
            p.grad = torch.from_numpy(grads[k])
        opt.step(lr)
    for k, p in tp:
        # fp32 moments; the bias corrections are float64 here, fp32 in optax
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)


# -- one whole training step ------------------------------------------------

T = 12
S = 32


@pytest.fixture(scope="module")
def step():
    """The JAX package's step on a pre-augmented two-view batch: SCL loss,
    gradients of the trainable parameters, one Adam update, the new BN
    statistics; all exported into the reference state-dict layout."""
    cfg = small_carl_cfg()
    cfg.MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE = 0.0
    cfg.USE_AMP = False
    rng = np.random.RandomState(0)
    x = rng.rand(1, T, S, S, 3).astype(np.float32)
    jmodel, variables = init_jax_carl(cfg, x)
    sd = convert_to_carl_state_dict(variables["params"],
                                    variables["batch_stats"], layer=3)
    # frames that differ in colour and contrast, so the batch-statistic BNs
    # of layer4 and the head see well-spread features (near-identical
    # frames make their variances tiny and the gradients ill-conditioned)
    videos = (rng.randn(1, 2, T, S, S, 3) * rng.uniform(0.2, 2.0, (1, 2, T, 1, 1, 1))
              + rng.randn(1, 2, T, 1, 1, 3) * 1.5).astype(np.float32)
    masks = np.ones((1, 2, T), np.float32)
    masks[0, 1, -4:] = 0
    batch = {"videos": videos, "video_masks": masks,
             "seq_lens": np.array([[40, 40]], np.int32),
             "chosen_steps": np.stack([np.sort(rng.choice(40, T, replace=False))
                                       for _ in range(2)])[None].astype(np.int32)}

    trainable, frozen = split_params(variables["params"], cfg)
    algo = JaxSCL(cfg)

    def loss_fn(tr):
        v = {"params": merge_params(tr, frozen),
             "batch_stats": variables["batch_stats"]}
        loss, updates = algo.compute_loss(jmodel, v, {k: jnp.asarray(a) for k, a in batch.items()},
                                          train=True, rngs={"dropout": jax.random.key(0)})
        return loss["loss"], updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    tx = make_optimizer(cfg)
    state = tx.init(trainable)
    lr = 1e-4
    state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    up, _ = tx.update(grads, state, trainable)
    new_trainable = optax.apply_updates(trainable, up)

    zeros = {k: np.zeros_like(v) for k, v in frozen.items()}
    grad_sd = convert_to_carl_state_dict(
        traverse_util.unflatten_dict({**grads, **zeros}),
        variables["batch_stats"], layer=3)
    new_sd = convert_to_carl_state_dict(merge_params(new_trainable, frozen),
                                        updates["batch_stats"], layer=3)
    # g + wd * p, what Adam's first step takes the sign of
    eff_sd = convert_to_carl_state_dict(
        traverse_util.unflatten_dict({**{k: grads[k] + cfg.OPTIMIZER.WEIGHT_DECAY * v
                                         for k, v in trainable.items()}, **zeros}),
        variables["batch_stats"], layer=3)
    return cfg, sd, batch, float(loss), grad_sd, new_sd, eff_sd, lr


def test_training_step_matches_jax(step):
    cfg, sd, batch, ref_loss, grad_sd, new_sd, eff_sd, lr = step
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_numpy(sd), strict=True)
    named = set_trainable(model, cfg.MODEL.TRAIN_BASE)
    opt = Optimizer(named, cfg)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = SCL(cfg).compute_loss(model, tb)["loss"]
    loss.backward()
    # fp32 through the frozen trunk, layer4 and the head, summed in another
    # order (features of order 1-10 differ by ~1e-5, `test_torch_model.py`):
    # 1e-5 of the loss's size
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    names = {n for n, _ in named}
    assert names and not any(n.startswith("backbone.") for n in names)
    for n, p in model.named_parameters():
        if p.grad is None:  # frozen, or the classifier SCL never runs
            assert not np.any(grad_sd[n]), n
            continue
        # gradients up to ~6 through the batch-statistic BNs of layer4 and
        # the head: the port's own gradients move by ~2e-4 when its input
        # moves by 1e-6 (relative), and the two packages differ by as much,
        # so each tensor is held to 1e-4 of its largest gradient (at least 1)
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
    opt.step(lr)
    state = model.state_dict()
    for n, want in new_sd.items():
        got = state[n].numpy()
        if n.endswith("num_batches_tracked") or n.startswith("classifier."):
            # the JAX SCL trainer has no classifier (this test's JAX model
            # was initialised with one, so optax decays it); the port's SCL
            # optimizer leaves it out
            continue
        if n in names:
            # Adam's first step is lr * sign(g + wd p) wherever |g| >> eps:
            # where the effective gradient is tiny, a 1e-4 gradient
            # difference may flip its sign, so those elements are held to
            # one step of 2 lr, the rest to fp32 rounding
            firm = np.abs(eff_sd[n]) > 1e-3
            np.testing.assert_allclose(got[firm], want[firm], atol=1e-6, err_msg=n)
            np.testing.assert_allclose(got, want, atol=2 * lr + 1e-6, err_msg=n)
        else:  # frozen weights and every BN statistic
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=n)


# -- checkpoint save -> resume ---------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    root = tmp_path_factory.mktemp("torch_train")
    make_pouring(str(root / "pouring"), num_train=2, num_val=1, min_len=14,
                 max_len=20, size=40, seed=0)
    return root


def _micro_cfg(root, logdir, epochs):
    cfg = small_carl_cfg()
    cfg.PATH_TO_DATASET = str(root / "pouring")
    cfg.LOGDIR = logdir
    cfg.TRAIN.NUM_FRAMES = 6
    cfg.TRAIN.MAX_EPOCHS = epochs
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 12
    cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS = 1
    cfg.CHECKPOINT.SAVE_INTERVAL = 1
    cfg.DATA.NUM_WORKERS = 0
    cfg.USE_AMP = False
    return cfg


def test_checkpoint_resume_continues_the_same_trajectory(synth, tmp_path):
    """One epoch, a checkpoint, a new trainer resuming from it for a second
    epoch == two epochs in one run: the same parameters, BN statistics and
    optimizer moments (each step's random values are keyed by epoch and
    iteration)."""
    from video_rep_learning_tpu_torch.train import Trainer

    def run(logdir, epochs):
        tr = Trainer(_micro_cfg(synth, logdir, epochs), no_eval=True, device="cpu")
        tr.init_state()
        tr.fit()
        return tr

    once = run(str(tmp_path / "a"), 2)
    first = run(str(tmp_path / "b"), 1)
    resumed = Trainer(_micro_cfg(synth, str(tmp_path / "b"), 2), no_eval=True,
                      device="cpu")
    assert resumed.init_state() == 1
    for (n, a), b in zip(first.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert resumed.optimizer.count == first.optimizer.count == 2
    resumed.fit()
    for (n, a), b in zip(once.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=n)
    for a, b in zip(once.optimizer.mu + once.optimizer.nu,
                    resumed.optimizer.mu + resumed.optimizer.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    assert copy.deepcopy(resumed.optimizer.state_dict())["count"] == 4
