"""Late fusion over a ViT in the port against the JAX package: the three
`configs_mvf/ablate_dinoB8_*` wirings (LATE_TYPE cls; LATE_TYPE spatial
with max and average pooling over the tapped tokens) on a test-only ViT
registered in both packages' `VIT_SPECS` (64-d, 2 blocks, 2 heads, patch 8
at 32 px: a 4 x 4 grid), exported from JAX with `convert_to_mvf_state_dict`
(`wrapped=False` for cls: the reference keeps that ViT under `backbone.*`)
and loaded strictly: the resolved `ModelSpec` of the shipped configs, the
backbone features the late head reads, the embeddings, one SCL training
step with its Adam update, and the reference layouts of the state dict.

Tolerances: fp32 on both sides, the same math summed in another order.
Embeddings: rtol 1e-5 with an absolute floor of 1e-5 of the largest value
(unit-norm rows, so a value near 0 has no relative scale of its own);
backbone features and the training step as `tests/test_torch_mvf_train.py`
holds them (the loss to 1e-5 relative, each gradient tensor to 1e-4 of its
largest value, the Adam step to fp32 rounding where the effective gradient
is firm, else to one step of 2 lr).
"""

import dataclasses
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
from video_rep_learning_tpu.models.carl import resolve_model_spec as jax_resolve
from video_rep_learning_tpu.models.import_torch import convert_to_mvf_state_dict
from video_rep_learning_tpu.train.optimizer import (make_optimizer, merge_params,
                                                    split_params)
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch.algos import SCL
from video_rep_learning_tpu_torch.models import (build_model, resolve_model_spec,
                                                 save_checkpoint, set_trainable,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import (load_model_state,
                                                         reference_state)
from video_rep_learning_tpu_torch.train import Optimizer

from tests.test_torch_model import perturb_batch_stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_VIT = "vit_late_test_64"
T, S, DEPTH, PATCH = 6, 32, 2, 8
CASES = {"cls": "ablate_dinoB8_cls.yml", "spatial_max": "ablate_dinoB8_max.yml",
         "spatial_avg": "ablate_dinoB8_avg.yml"}
EMB_RTOL, STEP_LR = 1e-5, 1e-4


def _yml(name):
    return os.path.join(REPO, "configs_mvf", name)


@pytest.mark.parametrize("kind", ["avg", "cls", "max"])
def test_model_spec_matches_jax(kind):
    """Every ModelSpec field both packages have, on the shipped config."""
    path = _yml(f"ablate_dinoB8_{kind}.yml")
    jcfg, pcfg = jax_config.get_cfg(), port_config.get_cfg()
    jax_config.load_yaml_into(jcfg, path)
    port_config.load_yaml_into(pcfg, path)
    want, got = jax_resolve(jcfg), resolve_model_spec(pcfg)
    common = ({f.name for f in dataclasses.fields(want)}
              & {f.name for f in dataclasses.fields(got)})
    assert {"out_channel", "tap_blocks", "flatten_method", "late_type"} <= common
    for name in sorted(common - {"vit_spec"}):
        assert getattr(got, name) == getattr(want, name), name
    assert dataclasses.asdict(got.vit_spec) == dataclasses.asdict(want.vit_spec)
    assert got.vit_front_blocks == want.vit_frozen_blocks == 12
    taps = () if kind == "cls" else (3, 7, 11)
    assert got.tap_blocks == taps and got.out_channel == 768 * max(1, len(taps))


@pytest.fixture(scope="module")
def test_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_SPECS, TEST_VIT,
                   jax_vit.ViTSpec(64, DEPTH, 2, PATCH, img_size=S))
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT,
                   port_vit.ViTSpec(64, DEPTH, 2, PATCH, img_size=S))
        yield


def small_late_cfg(config_module, case):
    cfg = config_module.get_cfg()
    config_module.load_yaml_into(cfg, _yml(CASES[case]))
    config_module.apply_opts(cfg, [
        "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}", "IMAGE_SIZE", str(S),
        "USE_AMP", "False", "TRAIN.NUM_FRAMES", str(T),
        "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "4",
        "MODEL.BASE_MODEL.LAYER", str(DEPTH),
        "MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,1",
        "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "2",
        "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
        "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1",
        "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
        "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
        "MODEL.EMBEDDER_MODEL.D_FF", "48",
        "MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE", "16",
        "MODEL.EMBEDDER_MODEL.FC_DROPOUT_RATE", "0.0",
        "MODEL.PROJECTION_SIZE", "24", "OPTIMIZER.WEIGHT_DECAY", "0.01"])
    return cfg


def _batch(rng, B=1):
    """Two views of B clips of frames that differ in colour and contrast, a
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


_MODELS = {}


@pytest.fixture
def late(test_vit, request):
    """(JAX model, variables, port config, exported reference dict, the
    port's model loaded from it, batch) for CASES[request.param], once a
    module; the JAX step's (loss, gradients, updated weights, g + wd p) are
    added by `_jax_step`."""
    case = request.param
    if case in _MODELS:
        return _MODELS[case]
    cfg = small_late_cfg(jax_config, case)
    jmodel = jax_build_model(cfg)
    batch = _batch(np.random.RandomState(0))

    def init_all(mdl, x, masks):
        return mdl(x, T, video_masks=masks, project=True)

    variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)},
        jnp.asarray(batch["videos"][:, 0]), jnp.ones((1, 1, T), jnp.float32))
    variables = {"params": variables["params"],
                 "batch_stats": perturb_batch_stats(variables["batch_stats"], 7)}
    sd = convert_to_mvf_state_dict(variables["params"], variables["batch_stats"],
                                   depth=DEPTH, patch_size=PATCH,
                                   wrapped=case != "cls")
    pcfg = small_late_cfg(port_config, case)
    model = build_model(pcfg)
    load_model_state(model, state_dict_from_numpy(sd))
    _MODELS[case] = dict(jmodel=jmodel, variables=variables, cfg=cfg, pcfg=pcfg,
                         sd=sd, model=model, batch=batch)
    return _MODELS[case]


@pytest.mark.parametrize("late", list(CASES), indirect=True)
def test_late_backbone_flat_matches_jax(late):
    """The features the late head pools: cls the final-norm CLS feature as
    a 1 x 1 grid, spatial the two tapped blocks' patch tokens on the 4 x 4
    grid, channels last, as the JAX package hands them over."""
    x = late["batch"]["videos"][0, 0]
    feats, cls = jax.jit(lambda v, a: late["jmodel"].apply(
        v, a, method="backbone_flat"))(late["variables"], jnp.asarray(x))
    with torch.inference_mode():
        tfeats, tcls = late["model"].backbone_flat(torch.from_numpy(x))
    grid = (1, 1, 64) if late["pcfg"].MODEL.EMBEDDER_MODEL.LATE_TYPE == "cls" \
        else (4, 4, 128)
    assert tfeats.shape == (T,) + grid == np.shape(feats)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(feats), atol=5e-5)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(cls), atol=5e-5)


@pytest.mark.parametrize("late", list(CASES), indirect=True)
@pytest.mark.parametrize("mode", ["embed", "project", "padded"])
def test_late_embeddings_match_jax(late, mode):
    n = 4 if mode == "padded" else T
    x = late["batch"]["videos"][:, 0]
    masks = np.zeros((1, 1, T), np.float32)
    masks[..., :n] = 1
    kw = dict(project=mode == "project")
    want = np.asarray(jax.jit(lambda v, a, m: late["jmodel"].apply(
        v, a, T, video_masks=m, train=False, true_seq_len=jnp.int32(n), **kw))(
            late["variables"], jnp.asarray(x), jnp.asarray(masks)))
    with torch.inference_mode():
        got = late["model"](torch.from_numpy(x), T, video_masks=torch.from_numpy(masks),
                            true_seq_len=n, **kw).numpy()
    assert got.shape == want.shape == (1, T, 16)
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=EMB_RTOL,
                               atol=EMB_RTOL * np.abs(want[:, :n]).max())


def _jax_step(late):
    """The JAX package's SCL step + Adam update on `late`, exported into the
    reference layout."""
    if "step" in late:
        return late["step"]
    cfg, jmodel, batch = late["cfg"], late["jmodel"], late["batch"]
    params, stats = late["variables"]["params"], late["variables"]["batch_stats"]
    trainable, frozen = split_params(params, cfg)
    assert trainable and all(k[0] != "backbone" for k in trainable)
    algo = JaxSCL(cfg)

    def loss_fn(tr):
        v = {"params": merge_params(tr, frozen), "batch_stats": stats}
        loss, updates = algo.compute_loss(
            jmodel, v, {k: jnp.asarray(a) for k, a in batch.items()}, train=True,
            rngs={"dropout": jax.random.key(0)})
        return loss["loss"], updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable)
    tx = make_optimizer(cfg)
    state = tx.init(trainable)
    state.hyperparams["learning_rate"] = jnp.asarray(STEP_LR, jnp.float32)
    up, _ = tx.update(grads, state, trainable)
    new_trainable = optax.apply_updates(trainable, up)
    zeros = {k: np.zeros_like(v) for k, v in frozen.items()}
    clip = min(1.0, cfg.OPTIMIZER.GRAD_CLIP / float(optax.global_norm(grads)))
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    wrapped = cfg.MODEL.EMBEDDER_MODEL.LATE_TYPE != "cls"

    def export(p, s):
        return convert_to_mvf_state_dict(p, s, depth=DEPTH, patch_size=PATCH,
                                         wrapped=wrapped)

    late["step"] = (
        float(loss), export(traverse_util.unflatten_dict({**grads, **zeros}), stats),
        export(merge_params(new_trainable, frozen), updates["batch_stats"]),
        export(traverse_util.unflatten_dict(
            {**{k: clip * grads[k] + wd * v for k, v in trainable.items()}, **zeros}),
            stats))
    return late["step"]


@pytest.mark.parametrize("late", list(CASES), indirect=True)
def test_late_training_step_matches_jax(late):
    """One SCL step (loss, every head gradient) and its Adam update; the ViT
    never trains and keeps its reference layout."""
    ref_loss, grad_sd, new_sd, eff_sd = _jax_step(late)
    cfg = late["pcfg"]
    model = build_model(cfg)
    load_model_state(model, state_dict_from_numpy(late["sd"]))
    named = set_trainable(model, cfg.MODEL.TRAIN_BASE)
    names = {n for n, _ in named}
    assert names and not any(n.startswith(("backbone.", "classifier.")) for n in names)
    opt = Optimizer(named, cfg)
    model.train()
    loss = SCL(cfg).compute_loss(
        model, {k: torch.from_numpy(v) for k, v in late["batch"].items()})
    loss["loss"].backward()
    np.testing.assert_allclose(loss["loss"].item(), ref_loss, rtol=1e-5)
    for n, p in named:
        scale = max(1.0, float(np.abs(grad_sd[n]).max()))
        np.testing.assert_allclose(p.grad.numpy(), grad_sd[n], atol=1e-4 * scale,
                                   err_msg=n)
    before = reference_state(model)
    opt.step(STEP_LR)
    after = reference_state(model)
    assert set(after) - {k for k in after if k.startswith("classifier.")} == set(new_sd)
    for n, got in after.items():
        if n.endswith("num_batches_tracked") or n.startswith("classifier."):
            continue
        got, want = got.numpy(), new_sd[n]
        if n.startswith("backbone."):  # the ViT is never trained
            assert torch.equal(torch.from_numpy(got), before[n]), n
        elif n in names:
            firm = np.abs(eff_sd[n]) > 1e-3
            np.testing.assert_allclose(got[firm], want[firm], atol=1e-6, err_msg=n)
            np.testing.assert_allclose(got, want, atol=2 * STEP_LR + 1e-6, err_msg=n)
        else:  # the BN statistics of the FC stack and the projection
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("late", ["cls", "spatial_max"], indirect=True)
def test_reference_layout_loads_strictly_and_round_trips(late, tmp_path):
    """The reference dict (cls: the ViT under `backbone.*`; spatial:
    `backbone.model.*`) loads strictly; the other layout does not; a saved
    checkpoint keeps the reference layout and reloads to the same
    tensors."""
    sd, cls = late["sd"], late["pcfg"].MODEL.EMBEDDER_MODEL.LATE_TYPE == "cls"
    vit_keys = [k for k in sd if k.startswith("backbone.")]
    assert vit_keys and all(k.startswith("backbone.model.") != cls for k in vit_keys)
    other = {(k.replace("backbone.", "backbone.model.", 1) if cls
              else k.replace("backbone.model.", "backbone.", 1)): v
             for k, v in sd.items()}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model_state(build_model(late["pcfg"]), state_dict_from_numpy(other))

    model = late["model"]
    path = save_checkpoint(model, str(tmp_path), 3)
    saved = torch.load(path, map_location="cpu", weights_only=False)["model_state"]
    assert set(saved) - {k for k in saved if k.startswith("classifier.")} == set(sd)
    for k, v in sd.items():
        assert torch.equal(saved[k], torch.from_numpy(np.array(v))), k
    torch.manual_seed(1)
    again = build_model(late["pcfg"])
    load_model_state(again, saved)
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in again.state_dict().items())
