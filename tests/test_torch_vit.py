"""The ViT kernels' plain versions against the JAX package's Pallas kernels,
run in interpret mode with the TPU gates forced on (as
`tests/test_pallas.py` runs them), at dim 128, 2 heads of 64, N 17 and 130,
in fp32 and bf16: LayerNorm (#8), LN + matmul + bias + activation (#6, three
activations), packed attention (#4) and the attention half-block (#5, both
TPU schedules). Then a whole `ViTBlock` and `ViTFrontEnd` (taps, final
norm, CLS) against the JAX module path in fp32, on the same weights.

Tolerances, as max |port - JAX|:
- fp32: the same fp32 math summed in another order (values of order 1-10,
  ~1e-6), plus the TPU kernel's erf: the A&S polynomial (1.5e-7, so GELU
  within 2e-6) where the plain version uses torch's erf; the half-block's
  max-free exp2 softmax and its fp32 prescale are exact to ~1e-7 relative.
  Measured: at most 1.2e-6.
- bf16: both sides round at the same points (the LN output, the qkv, p
  before P.V, the attention output, the residual sum), so a value differs
  only where the fp32 values on the two sides fall either side of a
  rounding boundary: one bf16 ulp of the output's largest value (2^-7 of
  it). Attention rounds p unnormalised on the TPU (the clamped exp2) and
  normalised here: two ulps. The half-block's default prescale rounds
  q * scale to bf16 on the TPU before q k^T (the port scales the fp32
  scores, as the module path does), moving the logits by up to 2^-8
  relative: two ulps. Measured: one ulp at most in every case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.ops import attention_pallas as jax_attn
from video_rep_learning_tpu.ops import layernorm_pallas as jax_ln
from video_rep_learning_tpu.ops import matmul_gelu_pallas as jax_mm
from video_rep_learning_tpu.ops import vit_block_pallas as jax_vb
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.ops.attention import (
    attention_maxsub, packed_attention_reference, packed_attn_args,
    packed_vit_attention)
from video_rep_learning_tpu_torch.ops.layernorm import (fused_layernorm,
                                                        layernorm_reference)
from video_rep_learning_tpu_torch.ops.matmul import (
    ln_matmul_bias_act, ln_matmul_bias_act_reference)
from video_rep_learning_tpu_torch.ops.vit_block import (
    vit_attention_block, vit_attention_block_reference)

torch.set_num_threads(1)

D, HEADS = 128, 2
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
FP32_ATOL = {"ln": 2e-6, "mm": 5e-6, "attn": 5e-6, "block": 5e-6}
BF16_ULPS = {"ln": 1, "mm": 1, "attn": 2, "block": 2}


@pytest.fixture
def tpu_interpret(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        yield


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _check(kind, dtype, got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "fp32":
        tol = FP32_ATOL[kind]
    else:
        tol = BF16_ULPS[kind] * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (kind, dtype, err, tol)


def _port(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][0])


def _jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_plain_matches_pallas(tpu_interpret, dtype, N):
    rng = np.random.RandomState(N)
    x = _rand(rng, 2, N, D, scale=2.0, shift=0.5)
    g, b = _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1)
    want = jax_ln.fused_layernorm(_jax(x, dtype), jnp.asarray(g), jnp.asarray(b))
    got = fused_layernorm(_port(x, dtype), torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == DTYPES[dtype][0]
    _check("ln", dtype, got, want)
    np.testing.assert_array_equal(
        got.float().numpy(),
        layernorm_reference(_port(x, dtype), torch.from_numpy(g),
                            torch.from_numpy(b)).float().numpy())


@pytest.mark.parametrize("activation", ["none", "gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ln_matmul_plain_matches_pallas(tpu_interpret, dtype, N, activation):
    rng = np.random.RandomState(N + 1)
    Fo = 512
    x = _rand(rng, 2, N, D, scale=2.0, shift=0.5)
    g, be = _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1)
    w, b = _rand(rng, Fo, D, scale=0.05), _rand(rng, Fo, scale=0.05)
    want = jax_mm.ln_matmul_bias_act(_jax(x, dtype), jnp.asarray(g),
                                     jnp.asarray(be), jnp.asarray(w.T),
                                     jnp.asarray(b), activation)
    t = torch.from_numpy
    got = ln_matmul_bias_act(_port(x, dtype), t(g), t(be), _port(w, dtype), t(b),
                             activation)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (2, N, Fo)
    _check("mm", dtype, got, want)


@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_packed_attention_plain_matches_pallas(tpu_interpret, dtype, N):
    rng = np.random.RandomState(N + 2)
    qkv = _rand(rng, 3, N, 3 * D)
    want = jax_attn.packed_vit_attention(_jax(qkv, dtype), HEADS)
    got = packed_vit_attention(_port(qkv, dtype), HEADS)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (3, N, D)
    _check("attn", dtype, got, want)


@pytest.mark.parametrize("value", [None, "0", "1", "true"])
def test_packed_attention_reads_maxsub_at_call_time(monkeypatch, value):
    """The bf16 kernel's softmax form follows VRL_ATTN_MAXSUB as the JAX
    package's `_use_maxsub` reads it, at each call: the launch arguments
    built for a call carry the value set just before it."""
    if value is None:
        monkeypatch.delenv("VRL_ATTN_MAXSUB", raising=False)
    else:
        monkeypatch.setenv("VRL_ATTN_MAXSUB", value)
    assert attention_maxsub() == jax_attn._use_maxsub()
    qkv = torch.zeros(2, 5, 3 * D, dtype=torch.bfloat16)
    out = torch.empty(2, 5, D, dtype=torch.bfloat16)
    args = packed_attn_args(qkv, out, HEADS)
    assert args[2:] == (2, HEADS, 5, D // HEADS, 1, int(value == "1"),
                        (D // HEADS) ** -0.5)
    monkeypatch.setenv("VRL_ATTN_MAXSUB", "0" if value == "1" else "1")
    assert packed_attn_args(qkv, out, HEADS)[7] == int(value != "1")


def _block_args(rng, N):
    x = _rand(rng, 2, N, D)
    g, be = _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1)
    wqkv, bqkv = _rand(rng, 3 * D, D, scale=0.05), _rand(rng, 3 * D, scale=0.05)
    wp, bp = _rand(rng, D, D, scale=0.05), _rand(rng, D, scale=0.05)
    return x, g, be, wqkv, bqkv, wp, bp


@pytest.mark.parametrize("schedule", ["transposed", "row_major"])
@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vit_attention_block_plain_matches_pallas(tpu_interpret, monkeypatch,
                                                  dtype, N, schedule):
    monkeypatch.setenv("VRL_VIT_BLOCK_T", "1" if schedule == "transposed" else "0")
    rng = np.random.RandomState(N + 3)
    x, g, be, wqkv, bqkv, wp, bp = _block_args(rng, N)
    j = jnp.asarray
    want = jax_vb.vit_attention_block(_jax(x, dtype), j(g), j(be), j(wqkv.T),
                                      j(bqkv), j(wp.T), j(bp), HEADS)
    t = torch.from_numpy
    got = vit_attention_block(_port(x, dtype), t(g), t(be), _port(wqkv, dtype),
                              t(bqkv), _port(wp, dtype), t(bp), HEADS)
    assert got.dtype == DTYPES[dtype][0]
    _check("block", dtype, got, want)
    # the half-block is the composition of the three plain versions
    np.testing.assert_array_equal(
        got.float().numpy(),
        vit_attention_block_reference(_port(x, dtype), t(g), t(be),
                                      _port(wqkv, dtype), t(bqkv),
                                      _port(wp, dtype), t(bp),
                                      HEADS).float().numpy())
    qkv = ln_matmul_bias_act_reference(_port(x, dtype), t(g), t(be),
                                       _port(wqkv, dtype), t(bqkv))
    assert qkv.dtype == DTYPES[dtype][0]
    assert packed_attention_reference(qkv, HEADS).dtype == DTYPES[dtype][0]


# ---------------------------------------------------------------------------
# whole modules against the JAX module path (CPU backend, fp32)
# ---------------------------------------------------------------------------

# fp32 on both sides through 2 blocks: sums in another order; the module
# path's attention divides the scores by sqrt(dh), the port multiplies
MODULE_ATOL = 5e-5
SPEC = port_vit.ViTSpec(D, 2, HEADS, 8, img_size=32)


def _block_state(p, prefix):
    """JAX ViTBlock params -> the port's (timm) names under `prefix`."""
    sd = {}
    for norm in ("norm1", "norm2"):
        sd[f"{prefix}{norm}.weight"] = p[norm]["scale"]
        sd[f"{prefix}{norm}.bias"] = p[norm]["bias"]
    for src, dst in (("qkv", "attn.qkv"), ("proj", "attn.proj")):
        sd[f"{prefix}{dst}.weight"] = np.asarray(p["attn"][src]["kernel"]).T
        sd[f"{prefix}{dst}.bias"] = p["attn"][src]["bias"]
    for src, dst in (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
        sd[f"{prefix}{dst}.weight"] = np.asarray(p[src]["kernel"]).T
        sd[f"{prefix}{dst}.bias"] = p[src]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def test_vit_block_matches_jax_module():
    rng = np.random.RandomState(20)
    x = _rand(rng, 2, 130, D)
    block = jax_vit.ViTBlock(dim=D, num_heads=HEADS)
    params = block.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    port = port_vit.ViTBlock(D, HEADS)
    port.load_state_dict(_block_state(params, ""), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=MODULE_ATOL)


@pytest.mark.parametrize("taps", [(1,), (0, 1)])
def test_vit_front_end_matches_jax_module(taps):
    rng = np.random.RandomState(21)
    x = rng.rand(3, 32, 32, 3).astype(np.float32)
    jspec = jax_vit.ViTSpec(D, 2, HEADS, 8, img_size=32)
    front = jax_vit.ViTFrontEnd(jspec, 2, taps, include_norm=True)
    params = front.init(jax.random.key(1), jnp.asarray(x))["params"]
    want_feats, want_cls = front.apply({"params": params}, jnp.asarray(x))

    sd = {}
    for i in range(2):
        sd.update(_block_state(params[f"block{i}"], f"model.blocks.{i}."))
    pk = np.asarray(params["patch_embed"]["kernel"])  # (p*p*3, D), (p, p, C) rows
    t = torch.from_numpy
    sd["model.patch_embed.proj.weight"] = t(
        pk.reshape(8, 8, 3, D).transpose(3, 2, 0, 1).copy())
    for key, value in (("patch_embed.proj.bias", params["patch_embed"]["bias"]),
                       ("cls_token", params["cls_token"]),
                       ("pos_embed", params["pos_embed"]),
                       ("norm.weight", params["norm"]["scale"]),
                       ("norm.bias", params["norm"]["bias"])):
        sd["model." + key] = t(np.array(value, np.float32))
    port = port_vit.ViTFrontEnd(SPEC, taps)
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        feats, cls = port(t(x).permute(0, 3, 1, 2))
    assert feats.shape == (3, 17, D * len(taps)) and cls.shape == (3, D)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=MODULE_ATOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), atol=MODULE_ATOL)
