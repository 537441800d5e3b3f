"""The port's transformer layers against the flax ones, on the same weights
moved through the bridge (`convert_to_carl_state_dict` ->
`state_dict_from_numpy` -> strict `load_state_dict`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu.models import embedder as jemb
from video_rep_learning_tpu.models import layers as jl
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu_torch.models import embedder as temb
from video_rep_learning_tpu_torch.models import layers as tl
from video_rep_learning_tpu_torch.models.weights import state_dict_from_numpy

torch.set_num_threads(1)

# fp32 on both sides: summation order of matmuls and reductions only
ATOL = 1e-5
# sin/cos of fp32 positions up to ~240: one ulp of the argument (1.5e-5)
# moves the value by as much
SINCOS_ATOL = 2e-5

B, T, C, D_MODEL, HEADS, D_FF = 2, 12, 24, 32, 2, 48
FC = (40, 32)


@pytest.mark.parametrize("seq_len,d_model,train_len", [
    (240, 256, None), (100, 256, 240), (300, 32, 240), (1, 16, 240),
])
def test_sincos_embedding_matches_jax(seq_len, d_model, train_len):
    ref = np.asarray(jl.sincos_embedding(seq_len, d_model, train_len))
    out = tl.sincos_embedding(seq_len, d_model, train_len).numpy()
    np.testing.assert_allclose(out, ref, atol=SINCOS_ATOL)


@pytest.mark.parametrize("true_n", [240, 150, 1, np.array([240, 75, 300])],
                         ids=["train_len", "shorter", "one", "vector"])
def test_sincos_embedding_dynamic_matches_jax(true_n):
    S = 300
    ref = np.asarray(jl.sincos_embedding_dynamic(S, 256, 240, true_n))
    out = tl.sincos_embedding_dynamic(S, 256, 240, true_n).numpy()
    n = np.max(true_n)
    np.testing.assert_allclose(out[:, :n], ref[:, :n], atol=SINCOS_ATOL)


def test_scaled_dot_attention_matches_jax():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 3, 10, 8).astype(np.float32) for _ in range(3))
    mask = (rng.rand(2, 1, 10, 10) > 0.3).astype(np.float32)
    ref = jl.scaled_dot_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask))
    out = tl.scaled_dot_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def embed_head():
    """A flax TransformerEmbModel with perturbed BN statistics, and its
    reference-layout state dict."""
    x = np.random.RandomState(1).rand(B, T, 2, 2, C).astype(np.float32)
    mod = jemb.TransformerEmbModel(D_MODEL, 16, FC, 0.1, "max_pool", 2, HEADS,
                                   D_FF, 240)
    variables = mod.init({"params": jax.random.key(0),
                          "dropout": jax.random.key(1)}, jnp.asarray(x))
    rng = np.random.RandomState(2)
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    stats = traverse_util.unflatten_dict({
        k: (0.1 * rng.randn(*v.shape) if k[-1] == "mean"
            else 0.5 + rng.rand(*v.shape)).astype(np.float32)
        for k, v in stats.items()})
    variables = {"params": variables["params"], "batch_stats": stats}
    sd = convert_to_carl_state_dict({"embed": variables["params"]},
                                    {"embed": stats}, layer=3)
    return mod, variables, state_dict_from_numpy(sd), x


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _key_mask():
    m = np.ones((B, 1, T), np.float32)
    m[1, :, 8:] = 0
    return m


def test_encoder_matches_flax(embed_head):
    _, variables, sd, _ = embed_head
    x = np.random.RandomState(3).randn(B, T, D_MODEL).astype(np.float32)
    mask = _key_mask()
    ref = jl.Encoder(D_MODEL, 0.1, HEADS, D_FF, 2).apply(
        {"params": variables["params"]["video_encoder"]}, jnp.asarray(x),
        jnp.asarray(mask))
    enc = tl.Encoder(D_MODEL, 0.1, HEADS, D_FF, 2).eval()
    enc.load_state_dict(_sub(sd, "embed.video_encoder."), strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_fcbn_stack_matches_flax(embed_head):
    _, variables, sd, _ = embed_head
    x = np.random.RandomState(4).randn(B * T, C).astype(np.float32)
    ref = jl.FCBNStack(FC, 0.1).apply(
        {"params": variables["params"]["fc_layers"],
         "batch_stats": variables["batch_stats"]["fc_layers"]}, jnp.asarray(x))
    stack = tl.FCBNStack(C, FC, 0.1).eval()
    stack.load_state_dict(_sub(sd, "embed.fc_layers."), strict=True)
    with torch.no_grad():
        out = stack(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("true_len", [None, 9])
def test_transformer_emb_model_matches_flax(embed_head, true_len):
    mod, variables, sd, x = embed_head
    mask = _key_mask()
    ref = mod.apply(variables, jnp.asarray(x), video_masks=jnp.asarray(mask),
                    true_len=true_len)
    head = temb.TransformerEmbModel(C, D_MODEL, 16, FC, 0.1, "max_pool", 2,
                                    HEADS, D_FF, 240).eval()
    head.load_state_dict(_sub(sd, "embed."), strict=True)
    with torch.no_grad():
        out = head(torch.from_numpy(x).permute(0, 1, 4, 2, 3),
                   video_masks=torch.from_numpy(mask), true_len=true_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
