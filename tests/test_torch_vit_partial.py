"""The partially frozen ViT in the port against the JAX package (the
gradients of its kernels are in `tests/test_torch_mlp.py`).

- A partial `ViTFrontEnd` (the raw token stream after block L-1) and the
  `ViTBackEnd` (blocks L.., taps at global indices, the final norm) against
  the JAX modules on the same weights, outputs and gradients, under each
  of the JAX package's MLP gates: the JAX module path on the CPU is the same
  function for every gate.
- One whole training step of a small MV-Former frozen up to block 1 of 3
  (blocks 1-2 and the norm trained, both tapped, MODEL.REMAT on, CLS_RES
  on so that the final norm's CLS feature reaches the loss): the SCL
  loss, the gradient of every trainable tensor (each `res_finetune` block
  and the norm included) and the Adam update against `SCL.compute_loss` +
  `jax.value_and_grad` + `make_optimizer`, under each gate and with
  TRAIN.BACKBONE_WARMUP active; REMAT on gives REMAT off's gradients; a
  warm start from a fully frozen reference `.pth`; the config checks; the
  train CLI on the CPU with a resume.

The JAX package cannot export a partial ViT (`convert_to_mvf_state_dict`
reads every block from `backbone`), so its `res_finetune/block{i}` and
`res_finetune/norm` are folded under `backbone` on the variable trees, and
the port loads the fully frozen layout through `split_vit_state`.

Tolerances: the modules as `tests/test_torch_vit.py` (5e-5, fp32 through up to 3 blocks;
gradients 1e-4 of their largest, at least 1); the training step as
`tests/test_torch_mvf_train.py` (loss 1e-5 relative, each gradient tensor
1e-4 of its largest value, the Adam step to fp32 rounding where the
effective gradient is firm, else to one step of 2 lr).
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
from flax.core import unfreeze

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
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.carl import resolve_model_spec
from video_rep_learning_tpu_torch.models.weights import (load_model_state,
                                                         split_vit_state,
                                                         state_dict_from_numpy)
from video_rep_learning_tpu_torch.train import Optimizer, Trainer

from tests.test_torch_mvf_train import LR, SPECS, TEST_VIT3, _batch, _cfg, test_vits  # noqa: F401
from tests.test_torch_mvformer import MVF_CFG, S, T, TEST_VIT
from tests.test_torch_vit import _block_state

torch.set_num_threads(1)

D, HEADS = 128, 2
MODULE_ATOL, MODULE_GRAD = 5e-5, 1e-4
GATES = {"default": {}, "fused_mlp": {"VRL_FUSED_MLP": "1"},
         "ln_mm_off": {"VRL_FUSED_LN_MM": "0"},
         "gelu_mm_off": {"VRL_FUSED_GELU_MM": "0"}}
PARTIAL_OPTS = ["MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT3}",
                "MODEL.BASE_MODEL.LAYER", "1",
                "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1,2", "MODEL.REMAT", "True",
                "MODEL.CLS_RES", "True"]
FRONT = 1  # frozen blocks of the partial models here


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _close(what, tol, got, want):
    """Each pair's max |got - want| within the tolerance times max(1,
    largest |want|)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        bound = tol * max(1.0, float(np.abs(b).max()))
        assert err <= bound, (what, i, err, bound)


# ---------------------------------------------------------------------------
# the split ViT modules
# ---------------------------------------------------------------------------

def _front_back_state(params_front, params_back, depth):
    """JAX ViTFrontEnd(num_blocks=1) + ViTBackEnd params -> the port's
    front (`model.*`) and back (`blocks.{i}`, `norm`) state dicts."""
    t = torch.from_numpy
    front = _block_state(params_front["block0"], "model.blocks.0.")
    pk = np.asarray(params_front["patch_embed"]["kernel"])
    front["model.patch_embed.proj.weight"] = t(
        pk.reshape(8, 8, 3, D).transpose(3, 2, 0, 1).copy())
    for key, value in (("patch_embed.proj.bias", params_front["patch_embed"]["bias"]),
                       ("cls_token", params_front["cls_token"]),
                       ("pos_embed", params_front["pos_embed"])):
        front["model." + key] = t(np.array(value, np.float32))
    back = {}
    for i in range(FRONT, depth):
        back.update(_block_state(params_back[f"block{i}"], f"blocks.{i}."))
    back["norm.weight"] = t(np.array(params_back["norm"]["scale"], np.float32))
    back["norm.bias"] = t(np.array(params_back["norm"]["bias"], np.float32))
    return front, back


@pytest.mark.parametrize("gate", list(GATES))
def test_partial_front_and_back_end_match_jax(monkeypatch, gate):
    for k, v in GATES[gate].items():
        monkeypatch.setenv(k, v)
    depth, taps = 3, (1, 2)
    rng = np.random.RandomState(31)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    jspec = jax_vit.ViTSpec(D, depth, HEADS, 8, img_size=32)
    jfront = jax_vit.ViTFrontEnd(jspec, FRONT, (), include_norm=False)
    pf = jfront.init(jax.random.key(2), jnp.asarray(x))["params"]
    tokens = jfront.apply({"params": pf}, jnp.asarray(x))
    jback = jax_vit.ViTBackEnd(jspec, FRONT, taps)
    pb = jback.init(jax.random.key(3), tokens)["params"]
    (want_feats, want_cls) = jback.apply({"params": pb}, tokens)
    ct_f, ct_c = _rand(rng, *want_feats.shape), _rand(rng, *want_cls.shape)

    def loss(p, tok):
        f, c = jback.apply({"params": p}, tok)
        return jnp.sum(f * ct_f) + jnp.sum(c * ct_c)

    gp, gtok = jax.grad(loss, argnums=(0, 1))(pb, tokens)

    spec = port_vit.ViTSpec(D, depth, HEADS, 8, img_size=32)
    front = port_vit.ViTFrontEnd(spec, (), num_blocks=FRONT)
    back = port_vit.ViTBackEnd(spec, FRONT, taps, grad_chunk=3)
    sd_front, sd_back = _front_back_state(pf, pb, depth)
    front.load_state_dict(sd_front, strict=True)
    back.load_state_dict(sd_back, strict=True)
    with torch.no_grad():
        got_tokens = front(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_tokens.numpy(), np.asarray(tokens), atol=MODULE_ATOL)
    tok = torch.from_numpy(np.array(tokens)).requires_grad_()
    feats, cls = back(tok)
    assert feats.shape == (4, 17, D * len(taps)) and cls.shape == (4, D)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want_feats),
                               atol=MODULE_ATOL)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(want_cls),
                               atol=MODULE_ATOL)
    ((feats * torch.from_numpy(ct_f)).sum() + (cls * torch.from_numpy(ct_c)).sum()).backward()
    grad_sd = _front_back_state(pf, jax.tree_util.tree_map(np.asarray, gp), depth)[1]
    got = [tok.grad] + [p.grad for _, p in back.named_parameters()]
    want = [gtok] + [grad_sd[n].numpy() for n, _ in back.named_parameters()]
    _close("back end", MODULE_GRAD, got, want)


# ---------------------------------------------------------------------------
# one whole training step of a partial MV-Former
# ---------------------------------------------------------------------------

def _fold(tree):
    """A partial CARLModel's variable tree with `res_finetune`'s blocks and
    norm under `backbone`, the layout `convert_to_mvf_state_dict` reads."""
    tree = unfreeze(tree)
    if "res_finetune" in tree:
        tree["backbone"] = {**tree["backbone"], **tree.pop("res_finetune")}
    return tree


_STEPS = {}


@pytest.fixture
def partial_step(test_vits, request):
    """The JAX package's step of the partial MV-Former (warmup on or off),
    in the fully frozen reference layout: (cfg, weights, batch, loss,
    gradients, updated weights, g + wd p), built once a module."""
    warmup = request.param
    if warmup in _STEPS:
        return _STEPS[warmup]
    # the JAX side without nn.remat: the same function, compiled faster; the
    # port runs REMAT on (and off, test_remat_gives_the_same_gradients)
    cfg = _cfg(jax_config, PARTIAL_OPTS + ["MODEL.REMAT", "False"])
    jmodel = jax_build_model(cfg)
    assert jmodel.spec.vit_frozen_blocks == FRONT
    rng = np.random.RandomState(1)
    batch = _batch(rng, 1)
    x = batch["videos"][:, 0]

    def init_all(mdl, x, masks):
        return mdl(x, T, video_masks=masks, project=True)

    variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
        {"params": jax.random.key(7), "dropout": jax.random.key(8)},
        jnp.asarray(x), jnp.ones((1, 1, T), jnp.float32))
    stats = variables["batch_stats"]
    params = variables["params"]
    depth = SPECS[TEST_VIT3][1]

    def export(p, s):
        return convert_to_mvf_state_dict(_fold(p), s, depth=depth, patch_size=8)

    trainable, frozen = split_params(params, cfg)
    assert any(k[0] == "res_finetune" for k in trainable)
    assert all(k[0] != "backbone" for k in trainable)
    algo = JaxSCL(cfg)

    def loss_fn(tr):
        v = {"params": merge_params(tr, frozen), "batch_stats": stats}
        loss, updates = algo.compute_loss(
            jmodel, v, {k: jnp.asarray(a) for k, a in batch.items()}, train=True,
            rngs={"dropout": jax.random.key(0)}, backbone_warmup_active=warmup)
        return loss["loss"], updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    tx = make_optimizer(cfg)
    state = tx.init(trainable)
    state.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
    up, _ = tx.update(grads, state, trainable)
    new_trainable = optax.apply_updates(trainable, up)
    zeros = {k: np.zeros_like(v) for k, v in frozen.items()}
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    norm = float(optax.global_norm(grads))
    clip = min(1.0, cfg.OPTIMIZER.GRAD_CLIP / norm)
    _STEPS[warmup] = (
        _cfg(port_config, PARTIAL_OPTS), export(params, stats), batch, float(loss),
        export(traverse_util.unflatten_dict({**grads, **zeros}), stats),
        export(merge_params(new_trainable, frozen), updates["batch_stats"]),
        export(traverse_util.unflatten_dict(
            {**{k: clip * grads[k] + wd * v for k, v in trainable.items()}, **zeros}),
            stats))
    return _STEPS[warmup]


def _port_step(cfg, sd, batch, warmup=False):
    """The port's loss and gradients for one step, loaded through the fully
    frozen layout."""
    model = build_model(cfg)
    load_model_state(model, state_dict_from_numpy(sd))
    named = set_trainable(model, cfg.MODEL.TRAIN_BASE)
    model.train()
    loss = SCL(cfg).compute_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 backbone_warmup_active=warmup)
    loss["loss"].backward()
    return model, named, loss["loss"].item()


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("partial_step", [False], indirect=True)
def test_partial_mvf_training_step_matches_jax(partial_step, monkeypatch, gate):
    for k, v in GATES[gate].items():
        monkeypatch.setenv(k, v)
    cfg, sd, batch, ref_loss, grad_sd, new_sd, eff_sd = partial_step
    grad_sd, new_sd, eff_sd = (split_vit_state(d, FRONT) for d in (grad_sd, new_sd, eff_sd))
    model, named, loss = _port_step(cfg, sd, batch)
    names = {n for n, _ in named}
    assert any(n.startswith("res_finetune.blocks.1.") for n in names)
    assert any(n.startswith("res_finetune.blocks.2.") for n in names)
    assert {"res_finetune.norm.weight", "res_finetune.norm.bias"} <= names
    assert not any(n.startswith(("backbone.", "classifier.")) for n in names)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    checked = 0
    for n, p in model.named_parameters():
        if p.grad is None:  # the frozen front, or the classifier SCL never runs
            assert n not in names and not np.any(grad_sd.get(n, 0)), n
            continue
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
        checked += 1
    assert checked == len(names)
    opt = Optimizer(named, cfg)
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
        elif n.startswith("backbone."):  # the frozen front never trains
            assert torch.equal(torch.from_numpy(got), before[n]), n
        else:  # the BN statistics of the FC stack
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("partial_step", [True], indirect=True)
def test_partial_step_under_backbone_warmup_matches_jax(partial_step):
    """TRAIN.BACKBONE_WARMUP stops the gradient at the backbone's features
    in the smart head; the back end then learns only through the CLS
    feature (CLS_RES), in both packages alike: the loss and every
    gradient agree."""
    cfg, sd, batch, ref_loss, grad_sd, *_ = partial_step
    grad_sd = split_vit_state(grad_sd, FRONT)
    model, named, loss = _port_step(cfg, sd, batch, warmup=True)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    names = {n for n, _ in named}
    for n, p in model.named_parameters():
        if p.grad is None:
            assert not np.any(grad_sd.get(n, 0)), n
            continue
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
    assert model.res_finetune.norm.weight.grad is not None
    assert names


@pytest.mark.parametrize("partial_step", [False], indirect=True)
def test_remat_gives_the_same_gradients(partial_step):
    """MODEL.REMAT recomputes the back end in the backward
    (`torch.utils.checkpoint`): the same loss and gradients as without."""
    cfg, sd, batch, *_ = partial_step
    grads = {}
    for remat in (True, False):
        c = copy.deepcopy(cfg)
        c.MODEL.REMAT = remat
        model, _, loss = _port_step(c, sd, batch)
        assert model.spec.remat == remat
        grads[remat] = (loss, {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None})
    (la, ga), (lb, gb) = grads[True], grads[False]
    assert la == lb and set(ga) == set(gb)
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("partial_step", [False], indirect=True)
def test_partial_warm_start_from_fully_frozen_pth(partial_step, tmp_path):
    """MODEL.PRETRAINED_CHECKPOINT with a fully frozen reference `.pth`
    (every block under `backbone.model`) loads strictly into the partial
    model: blocks >= LAYER and the norm land in `res_finetune`."""
    cfg, sd, *_ = partial_step
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state": state_dict_from_numpy(sd)}, path)
    cfg = copy.deepcopy(cfg)
    cfg.MODEL.PRETRAINED_CHECKPOINT = path
    state = Trainer(cfg, build_loaders=False, device="cpu").model.state_dict()
    mapped = split_vit_state(state_dict_from_numpy(sd), FRONT)
    assert "res_finetune.blocks.2.mlp.fc2.weight" in mapped
    assert "backbone.model.blocks.1.norm1.weight" not in state
    for n, v in mapped.items():
        assert torch.equal(state[n], v), n


def test_partial_vit_config_checks(test_vits):
    """A SMART_FEATS tap below LAYER raises, as in the JAX package; a
    ViT under TRAIN_BASE train_all still waits for its slice."""
    cfg = _cfg(port_config, PARTIAL_OPTS)
    spec = resolve_model_spec(cfg)
    assert spec.vit_front_blocks == FRONT and spec.remat and spec.tap_blocks == (1, 2)
    cfg.MODEL.EMBEDDER_MODEL.SMART_FEATS = "0,2"
    with pytest.raises(ValueError, match="below the frozen/finetune split"):
        resolve_model_spec(cfg)
    with pytest.raises(ValueError, match="below the frozen/finetune split"):
        jax_build_model(_cfg(jax_config, PARTIAL_OPTS + [
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,2"]))
    cfg.MODEL.BASE_MODEL.LAYER = 12  # fully frozen: any tap
    assert resolve_model_spec(cfg).vit_front_blocks == 3
    cfg.MODEL.BASE_MODEL.LAYER = 1
    cfg.MODEL.EMBEDDER_MODEL.SMART_FEATS = "2"
    cfg.MODEL.TRAIN_BASE = "train_all"
    with pytest.raises(NotImplementedError, match="train_all"):
        resolve_model_spec(cfg)


def test_train_cli_trains_partial_vit_on_cpu_and_resumes(test_vits, tmp_path):
    """`python -m video_rep_learning_tpu_torch.train --device cpu` on a
    shrunk pouring_mvf.yml frozen up to block 1 of 2, REMAT on, CLS_RES on
    (so the final norm trains too), USE_AMP kept (bf16): one epoch with a checkpoint, then `--continue_train` from it.
    The checkpoint carries the partial layout and resumes strictly; the
    back end and the head move, the front stays as built."""
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    make_pouring(str(tmp_path / "pouring"), num_train=2, num_val=1, min_len=10,
                 max_len=14, size=40, seed=0)
    logdir = str(tmp_path / "logs")
    opts = ["IMAGE_SIZE", str(S), "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}",
            "MODEL.BASE_MODEL.LAYER", "1", "MODEL.REMAT", "True",
            "MODEL.CLS_RES", "True", "TRAIN.NUM_FRAMES", "4", "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "4",
            "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
            "MODEL.EMBEDDER_MODEL.D_FF", "48", "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
            "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
            "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1",
            "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
            "MODEL.PROJECTION_SIZE", "24",
            "CHECKPOINT.SAVE_INTERVAL", "1", "DATA.NUM_WORKERS", "0",
            "EVAL.FRAMES_PER_BATCH", "8", "EVAL.TASKS", "[kendalls_tau]"]

    def argv(epochs, *flags):
        return ["--workdir", str(tmp_path), "--logdir", logdir, "--cfg_file",
                MVF_CFG, "--device", "cpu", *flags, "--opts", *opts,
                "TRAIN.MAX_EPOCHS", str(epochs)]

    first = train_main(argv(1))
    saved_state = torch.load(os.path.join(logdir, "checkpoints",
                                          "checkpoint_epoch_00000.pth"),
                             weights_only=False)["model_state"]
    assert "res_finetune.blocks.1.mlp.fc1.weight" in saved_state
    assert not any(k.startswith("backbone.model.blocks.1.") for k in saved_state)
    resumed = train_main(argv(2, "--continue_train", "--tempcfg"))
    assert resumed.start_epoch == 1 and resumed.model.spec.vit_front_blocks == 1
    torch.manual_seed(resumed.cfg.RNG_SEED)
    init = build_model(resumed.cfg).state_dict()
    trainable = {n for n, p in resumed.model.named_parameters() if p.requires_grad}
    assert any(n.startswith("res_finetune.") for n in trainable)
    after, saved = resumed.model.state_dict(), first.model.state_dict()
    for n, v in after.items():
        if n.startswith("backbone."):
            assert torch.equal(v, init[n]) and torch.equal(saved[n], init[n]), n
        elif n in trainable:
            assert not torch.equal(v, saved[n]), n
