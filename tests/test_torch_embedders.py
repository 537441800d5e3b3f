"""The conv and vanilla context embedders of the port against the JAX
package's (`ConvEmbed` with k 3 / tpad 1 and k 1 / tpad 0, `VanillaEmbed`;
2 contexts; eval-mode and train-mode BN, with the updated statistics and
the input gradient), their weights carried by
`models/weights.py::context_embed_state_dict`; `resolve_model_spec` of
every conv / vanilla configuration against the JAX package's; and the
whole conv model's NUM_CONTEXTS 2 eval sweep against JAX's
`iter_video_embeddings` on the same weights, loaded strictly."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu.config import get_cfg as jax_get_cfg
from video_rep_learning_tpu.config import load_yaml_into as jax_load_yaml
from video_rep_learning_tpu.evaluation.embedding import \
    iter_video_embeddings as jax_iter_video_embeddings
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models.carl import \
    resolve_model_spec as jax_resolve_model_spec
from video_rep_learning_tpu.models.embedder import ConvEmbed as JaxConvEmbed
from video_rep_learning_tpu.models.embedder import VanillaEmbed as JaxVanillaEmbed
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu_torch.config import get_cfg, load_yaml_into
from video_rep_learning_tpu_torch.evaluation.embedding import iter_video_embeddings
from video_rep_learning_tpu_torch.models import (build_model,
                                                 context_embed_state_dict,
                                                 resolve_model_spec,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.models.embedder import ConvEmbed
from video_rep_learning_tpu_torch.models.weights import load_model_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: convolutions and products summed in another order
ATOL = 1e-5
B, T, CTX, C, HW = 2, 3, 2, 16, 4


def perturbed_stats(stats, seed):
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(stats)
    return traverse_util.unflatten_dict({
        k: (0.1 * rng.randn(*v.shape) if k[-1] == "mean"
            else 0.5 + rng.rand(*v.shape)).astype(np.float32)
        for k, v in flat.items()})


def flat_embed(variables):
    """The embedder's variables as the converter takes them: flat dicts
    keyed by flax path tuples under ("embed", ...)."""
    return (traverse_util.flatten_dict({"embed": variables["params"]}),
            traverse_util.flatten_dict({"embed": variables.get("batch_stats", {})}))


def _embedder(kind, conv_params):
    fc, emb = (12,), 6
    if kind == "conv":
        return (JaxConvEmbed(emb, conv_params, fc, 0.0, CTX),
                ConvEmbed(C, emb, conv_params, fc, 0.0, CTX))
    # the port's vanilla embedder is its conv embedder without conv layers
    return JaxVanillaEmbed(emb, fc, 0.0, CTX), ConvEmbed(C, emb, (), fc, 0.0, CTX)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
@pytest.mark.parametrize("kind,conv_params", [
    ("conv", ((8, 3, 1), (8, 1, 0))),  # k 3 over a 4x4 grid with tpad 1, then k 1
    ("conv", ((8, 1, 0),)),
    ("vanilla", ())], ids=["conv_k3_k1", "conv_k1", "vanilla"])
def test_context_embedder_matches_jax(kind, conv_params, train):
    rng = np.random.RandomState(0)
    x = rng.randn(B, T * CTX, HW, HW, C).astype(np.float32)  # NHWC, as JAX's
    jmod, mod = _embedder(kind, conv_params)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), T)
    if "batch_stats" in variables:
        variables = {"params": variables["params"],
                     "batch_stats": perturbed_stats(variables["batch_stats"], 1)}
    sd = context_embed_state_dict(*flat_embed(variables))
    mod.load_state_dict(state_dict_from_numpy(
        {k[len("embed."):]: v for k, v in sd.items()}), strict=True)
    mod.train(train)
    g = rng.randn(B, T, 6).astype(np.float32)  # upstream gradient

    def jfn(a):
        out = jmod.apply(variables, a, T, train=train,
                         mutable=["batch_stats"] if train else False)
        y, upd = out if train else (out, {})
        return jnp.sum(y * g), (y, upd)

    (_, (ref, upd)), ref_gx = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3).requires_grad_()
    out = mod(xt, T)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.shape == (B, T, 6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(ref_gx), atol=ATOL)
    if train and kind == "conv":
        new = context_embed_state_dict(*flat_embed(
            {"params": variables["params"], "batch_stats": upd["batch_stats"]}))
        state = mod.state_dict()
        for k, v in new.items():
            if "running_" in k:
                np.testing.assert_allclose(state[k[len("embed."):]].numpy(), v,
                                           atol=ATOL, err_msg=k)


def test_context_embedder_refuses_a_wrong_context_split():
    _, mod = _embedder("vanilla", ())
    with pytest.raises(ValueError, match="contexts"):
        mod(torch.zeros(B, T * CTX + 1, C, HW, HW), T)


def _conv_configs():
    """Every shipped configuration with a conv embedder, as it ships and as
    vanilla, at LAYER 2, 3 and 4."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yml"))):
        cfg = get_cfg()
        load_yaml_into(cfg, path)
        if cfg.MODEL.EMBEDDER_TYPE != "conv":
            continue
        for embedder in ("conv", "vanilla"):
            for layer in (2, 3, 4):
                out.append((os.path.basename(path), embedder, layer))
    return out


@pytest.mark.parametrize("name,embedder,layer", _conv_configs())
def test_context_model_spec_matches_jax(name, embedder, layer):
    specs = []
    for get, load, resolve in ((get_cfg, load_yaml_into, resolve_model_spec),
                               (jax_get_cfg, jax_load_yaml, jax_resolve_model_spec)):
        cfg = get()
        load(cfg, os.path.join(REPO, "configs", name))
        cfg.MODEL.EMBEDDER_TYPE = embedder
        cfg.MODEL.BASE_MODEL.LAYER = layer
        specs.append(resolve(cfg))
    port, ref = specs
    for field in ("embedder_type", "resnet_trunk_upto", "resnet_finetune_start",
                  "out_channel", "conv_params", "num_contexts", "fc_channels",
                  "embedding_size", "train_base"):
        assert getattr(port, field) == getattr(ref, field), field


# -- the whole conv model's NUM_CONTEXTS 2 eval sweep ----------------------

S, SEQ = 32, 10


def small_conv_cfg(get):
    cfg = get()
    cfg.IMAGE_SIZE = S
    cfg.MODEL.EMBEDDER_TYPE = "conv"
    cfg.MODEL.L2_NORMALIZE = False
    cfg.MODEL.PROJECTION = False
    cfg.DATA.NUM_CONTEXTS = 2
    cfg.DATA.CONTEXT_STRIDE = 3  # the first steps' contexts clip at frame 0
    cfg.EVAL.FRAMES_PER_BATCH = 5  # two chunks of 5 steps x 2 contexts
    e = cfg.MODEL.EMBEDDER_MODEL
    # layer3 gives a 2x2 grid at 32 px: kernels of size 1
    e.CONV_LAYERS = [[8, 1, 0]]
    e.FC_LAYERS = [[16, True]]
    e.CAPACITY_SCALAR = 1
    e.EMBEDDING_SIZE = 8
    return cfg


def trunk_state(params, batch_stats):
    """The reference layout's `backbone.*` keys of a conv model: the JAX
    exporter takes its backbone subtree beside a stand-in late-fusion head
    (it emits `embed.video_emb` whatever the head), whose keys are dropped."""
    stand_in = {"video_emb": {"Dense_0": {"kernel": np.zeros((1, 1), np.float32)}},
                "embedding_layer": {"Dense_0": {"kernel": np.zeros((1, 1), np.float32)}}}
    sd = convert_to_carl_state_dict({"backbone": params["backbone"], "embed": stand_in},
                                    {"backbone": batch_stats["backbone"]}, layer=3)
    return {k: v for k, v in sd.items() if k.startswith("backbone.")}


def conv_model_pair(cfg_jax, cfg_port, seed=0):
    """The JAX conv model and its variables (perturbed BN statistics), and
    the port's model with the same weights, loaded strictly."""
    jmodel = jax_build_model(cfg_jax)
    n = 2 * cfg_jax.TRAIN.NUM_FRAMES
    x = np.zeros((1, n, S, S, 3), np.float32)
    variables = jax.jit(lambda r, a: jmodel.init(r, a, n // 2))(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        jnp.asarray(x))
    variables = {"params": variables["params"],
                 "batch_stats": perturbed_stats(variables["batch_stats"], seed + 2)}
    sd = trunk_state(variables["params"], variables["batch_stats"])
    flat_p = traverse_util.flatten_dict(variables["params"])
    flat_s = traverse_util.flatten_dict(variables["batch_stats"])
    sd.update(context_embed_state_dict(flat_p, flat_s))
    model = build_model(cfg_port)
    load_model_state(model, state_dict_from_numpy(sd))
    return jmodel, variables, model


def test_context_eval_sweep_matches_jax():
    cfg_jax, cfg_port = small_conv_cfg(jax_get_cfg), small_conv_cfg(get_cfg)
    cfg_jax.TRAIN.NUM_FRAMES = cfg_port.TRAIN.NUM_FRAMES = 5
    jmodel, variables, model = conv_model_pair(cfg_jax, cfg_port)
    rng = np.random.RandomState(5)
    # frames that differ in colour and contrast, on a 40 x 40 canvas with
    # the clip's true 36 x 40 extent
    video = np.clip(rng.uniform(30, 225, (SEQ, 1, 1, 3))
                    + rng.uniform(5, 60, (SEQ, 1, 1, 1))
                    * rng.randn(SEQ, 40, 40, 3), 0, 255).astype(np.uint8)
    item = {"video": video, "seq_len": SEQ, "name": "v0",
            "labels": np.where(np.arange(SEQ) == 4, -1, np.arange(SEQ) % 3),
            "chosen_steps": np.arange(SEQ),
            "dims": np.array([36, 40], np.float32)}
    ref = next(jax_iter_video_embeddings(cfg_jax, jmodel, variables, [item]))
    with torch.inference_mode():
        got = next(iter_video_embeddings(cfg_port, model, [item], "cpu"))
    assert got["embs"].shape == ref["embs"].shape == (SEQ - 1, 8)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    # ResNet-50 through layer3 in fp32, summed in another order by XLA and
    # oneDNN (`test_torch_model.py`'s 1e-4 on features of order 1-10)
    np.testing.assert_allclose(got["embs"], np.asarray(ref["embs"]), atol=1e-4)
