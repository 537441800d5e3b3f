"""MV-Former training in the port against the JAX package: one whole
training step (the SCL loss, the gradient of every trainable tensor, one Adam
update and the new BN statistics) of a small MV-Former against
`SCL.compute_loss` + `jax.value_and_grad` + `make_optimizer`, on the same
weights (`convert_to_mvf_state_dict`) and pre-augmented frames, dropout off;
a warm start from such a `.pth`; the TRAIN.BACKBONE_WARMUP gate; and
`python -m video_rep_learning_tpu_torch.train` on the CPU over a shrunk
`configs_mvf/pouring_mvf.yml` with a checkpoint resume.

Cases: `pouring_mvf` (one tap, single_noself, one clip) and a 3-tap
`batch_noself` one over two clips (k400_mvf.yml's loss), on test-only ViT
specs registered in both packages' `VIT_SPECS`.

Tolerances as `tests/test_torch_train.py` states them for CARL: fp32 on both
sides, the same math summed in another order: the loss to 1e-5 relative;
each gradient tensor to 1e-4 of its largest value (at least 1), through the
batch-statistic BN of the FC stack; the Adam step to fp32 rounding where
the effective gradient is firm, else to one step of 2 lr.
"""

import copy
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.algos.scl import SCL as JaxSCL
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.models.import_torch import convert_to_mvf_state_dict
from video_rep_learning_tpu.train.optimizer import (make_optimizer, merge_params,
                                                    split_params)
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch.algos import SCL
from video_rep_learning_tpu_torch.models import build_model, set_trainable
from video_rep_learning_tpu_torch.models import mvformer as port_mvf
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import (load_model_state,
                                                         state_dict_from_numpy)
from video_rep_learning_tpu_torch.train import Optimizer, Trainer

from tests.test_torch_model import perturb_batch_stats
from tests.test_torch_mvformer import MVF_CFG, S, T, TEST_VIT, small_mvf_cfg

torch.set_num_threads(1)

TEST_VIT3 = "vit_test_128_d3"
SPECS = {TEST_VIT: (128, 2, 2, 8), TEST_VIT3: (128, 3, 2, 8)}
# name -> (ViT, clips, extra opts)
STEP_CASES = {
    "pouring_mvf": (TEST_VIT, 1, []),
    "batch_noself_3tap": (TEST_VIT3, 2, [
        "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT3}",
        "MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,1,2",
        "SCL.NEGATIVE_TYPE", "batch_noself"]),
}
LR = 1e-4


@pytest.fixture(scope="module")
def test_vits():
    with pytest.MonkeyPatch.context() as mp:
        for name, (dim, depth, heads, patch) in SPECS.items():
            mp.setitem(jax_vit.VIT_SPECS, name,
                       jax_vit.ViTSpec(dim, depth, heads, patch, img_size=S))
            mp.setitem(port_vit.VIT_SPECS, name,
                       port_vit.ViTSpec(dim, depth, heads, patch, img_size=S))
        yield


def _cfg(config_module, extra):
    cfg = small_mvf_cfg(config_module, [
        "MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE", "0.0", *extra])
    cfg.OPTIMIZER.WEIGHT_DECAY = 1e-2
    return cfg


def _batch(rng, B):
    """Two views of B clips of frames that differ in colour and contrast
    (batch-statistic BN over near-identical frames is ill-conditioned), a
    masked tail, realistic steps and lengths."""
    videos = (rng.randn(B, 2, T, S, S, 3) * rng.uniform(0.2, 2.0, (B, 2, T, 1, 1, 1))
              + rng.randn(B, 2, T, 1, 1, 3) * 1.5).astype(np.float32)
    masks = np.ones((B, 2, T), np.float32)
    masks[0, 1, -2:] = 0
    steps = np.stack([np.sort(rng.choice(40, T, replace=False))
                      for _ in range(2 * B)]).reshape(B, 2, T)
    return {"videos": videos, "video_masks": masks,
            "seq_lens": rng.randint(30, 40, (B, 2)).astype(np.int32),
            "chosen_steps": steps.astype(np.int32)}


_STEPS = {}


@pytest.fixture
def step(test_vits, request):
    """The JAX package's step for STEP_CASES[request.param], exported into
    the reference layout: (cfg, weights, batch, loss, gradients, updated
    weights, g + wd p), built once a module."""
    case = request.param
    if case in _STEPS:
        return _STEPS[case]
    vit, B, extra = STEP_CASES[case]
    depth = SPECS[vit][1]
    cfg = _cfg(jax_config, extra)
    jmodel = jax_build_model(cfg)
    rng = np.random.RandomState(0)
    batch = _batch(rng, B)
    x = batch["videos"][:, 0]

    def init_all(mdl, x, masks):
        return mdl(x, T, video_masks=masks, project=True)

    variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)},
        jnp.asarray(x), jnp.ones((B, 1, T), jnp.float32))
    stats = perturb_batch_stats(variables["batch_stats"], 7)
    params = variables["params"]

    def export(p, s):
        return convert_to_mvf_state_dict(p, s, depth=depth, patch_size=8)

    trainable, frozen = split_params(params, cfg)
    assert trainable and all(k[0] != "backbone" for k in trainable)
    algo = JaxSCL(cfg)

    def loss_fn(tr):
        v = {"params": merge_params(tr, frozen), "batch_stats": stats}
        loss, updates = algo.compute_loss(
            jmodel, v, {k: jnp.asarray(a) for k, a in batch.items()}, train=True,
            rngs={"dropout": jax.random.key(0)})
        return loss["loss"], updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    tx = make_optimizer(cfg)
    state = tx.init(trainable)
    state.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
    up, _ = tx.update(grads, state, trainable)
    new_trainable = optax.apply_updates(trainable, up)
    zeros = {k: np.zeros_like(v) for k, v in frozen.items()}
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    # what Adam's first step takes the sign of: the clipped gradient + wd p
    norm = float(optax.global_norm(grads))
    clip = min(1.0, cfg.OPTIMIZER.GRAD_CLIP / norm)
    _STEPS[case] = (
        _cfg(port_config, extra), export(params, stats), batch, float(loss),
        export(traverse_util.unflatten_dict({**grads, **zeros}), stats),
        export(merge_params(new_trainable, frozen), updates["batch_stats"]),
        export(traverse_util.unflatten_dict(
            {**{k: clip * grads[k] + wd * v for k, v in trainable.items()}, **zeros}),
            stats))
    return _STEPS[case]


@pytest.mark.parametrize("step", list(STEP_CASES), indirect=True)
def test_mvf_training_step_matches_jax(step):
    cfg, sd, batch, ref_loss, grad_sd, new_sd, eff_sd = step
    model = build_model(cfg)
    load_model_state(model, state_dict_from_numpy(sd))
    named = set_trainable(model, cfg.MODEL.TRAIN_BASE)
    names = {n for n, _ in named}
    assert names and not any(n.startswith(("backbone.", "classifier.")) for n in names)
    opt = Optimizer(named, cfg)
    model.train()
    loss = SCL(cfg).compute_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss["loss"].backward()
    np.testing.assert_allclose(loss["loss"].item(), ref_loss, rtol=1e-5)
    checked = 0
    for n, p in model.named_parameters():
        if p.grad is None:  # the frozen ViT, or the classifier SCL never runs
            assert n not in names and not np.any(grad_sd.get(n, 0)), n
            continue
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
        checked += 1
    assert checked == len(names)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    opt.step(LR)
    for n, got in model.state_dict().items():
        if n.endswith("num_batches_tracked") or n.startswith("classifier."):
            continue
        got, want = got.numpy(), new_sd[n]
        if n in names:
            firm = np.abs(eff_sd[n]) > 1e-3
            np.testing.assert_allclose(got[firm], want[firm], atol=1e-6, err_msg=n)
            np.testing.assert_allclose(got, want, atol=2 * LR + 1e-6, err_msg=n)
        elif n.startswith("backbone."):  # the ViT is never trained
            assert torch.equal(torch.from_numpy(got), before[n]), n
        else:  # the BN statistics of the FC stack
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("step", ["pouring_mvf"], indirect=True)
def test_warm_start_from_reference_pth(step, tmp_path):
    """MODEL.PRETRAINED_CHECKPOINT with a `.pth` in the reference layout
    (`convert_to_mvf_state_dict`, no classifier) loads into the MV-Former
    strictly, as the JAX trainer's `load_mvf_checkpoint` branch does."""
    cfg, sd, *_ = step
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state": state_dict_from_numpy(sd)}, path)
    cfg = copy.deepcopy(cfg)
    cfg.MODEL.PRETRAINED_CHECKPOINT = path
    trainer = Trainer(cfg, build_loaders=False, device="cpu")
    state = trainer.model.state_dict()
    for n, v in state_dict_from_numpy(sd).items():
        assert torch.equal(state[n], v), n


def test_backbone_warmup_gate():
    """TRAIN.BACKBONE_WARMUP: active for the epochs before it, only with
    smart fusion (ValueError otherwise, `train.py:81-85`); it stops the
    gradient at the backbone's features in the multi-entity head."""
    cfg = port_config.get_cfg()
    port_config.load_yaml_into(cfg, MVF_CFG)
    gate = Trainer.backbone_warmup_active
    holder = type("T", (), {"cfg": cfg})()
    assert [gate(holder, e) for e in range(3)] == [False] * 3
    cfg.TRAIN.BACKBONE_WARMUP = 2
    assert [gate(holder, e) for e in range(3)] == [True, True, False]
    cfg.MODEL.EMBEDDER_MODEL.FUSION_TYPE = "late"
    with pytest.raises(ValueError, match="BACKBONE_WARMUP requires smart fusion"):
        gate(holder, 0)

    head = port_mvf.MultiEntityTransformerEmbModel(
        8, 16, 8, (16,), 0.0, 1, 2, 16, 4, 2, 0, 8).train()
    for active in (False, True):
        x = torch.randn(2, 4, 2, 2, 8, requires_grad=True)
        head(x, backbone_warmup_active=active).sum().backward()
        assert (x.grad is None) == active


def test_train_cli_trains_mvf_on_cpu_and_resumes(test_vits, tmp_path):
    """`python -m video_rep_learning_tpu_torch.train --device cpu` on a
    shrunk pouring_mvf.yml (USE_AMP kept: the ViT runs in bf16) over the
    synthetic set: one epoch with a checkpoint, then `--continue_train` for
    a second; the head moves, the ViT stays as it was built."""
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    make_pouring(str(tmp_path / "pouring"), num_train=2, num_val=1, min_len=10,
                 max_len=14, size=40, seed=0)
    logdir = str(tmp_path / "logs")
    opts = ["IMAGE_SIZE", str(S), "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}",
            "TRAIN.NUM_FRAMES", "4", "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "4",
            "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
            "MODEL.EMBEDDER_MODEL.D_FF", "48", "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
            "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
            "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1",
            "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
            "MODEL.PROJECTION_SIZE", "24", "TRAIN.BACKBONE_WARMUP", "1",
            "CHECKPOINT.SAVE_INTERVAL", "1", "DATA.NUM_WORKERS", "0",
            "EVAL.FRAMES_PER_BATCH", "8", "EVAL.TASKS", "[kendalls_tau]"]

    def argv(epochs, *flags):
        return ["--workdir", str(tmp_path), "--logdir", logdir, "--cfg_file",
                MVF_CFG, "--device", "cpu", *flags, "--opts", *opts,
                "TRAIN.MAX_EPOCHS", str(epochs)]

    first = train_main(argv(1))
    assert os.listdir(os.path.join(logdir, "checkpoints")) == [
        "checkpoint_epoch_00000.pth"]
    resumed = train_main(argv(2, "--continue_train", "--tempcfg"))
    assert resumed.start_epoch == 1
    torch.manual_seed(resumed.cfg.RNG_SEED)
    init = build_model(resumed.cfg).state_dict()
    trainable = {n for n, p in resumed.model.named_parameters() if p.requires_grad}
    after, saved = resumed.model.state_dict(), first.model.state_dict()
    for n, v in after.items():
        if n.startswith("backbone."):
            assert torch.equal(v, init[n]) and torch.equal(saved[n], init[n]), n
        elif n in trainable:
            assert not torch.equal(v, saved[n]), n
