"""The port's flash-attention plain version against the JAX package: its XLA
reference and its Pallas kernel, run in interpret mode as
`tests/test_pallas.py` runs it on the CPU. On a CPU tensor the port's wrapper
takes the plain version, so this also pins what the CUDA kernel is held to
(`chip_smoke.py` compares the two on the card)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu.ops.attention_pallas import (_attention_reference,
                                                         _fused_forward,
                                                         flash_attention)
from video_rep_learning_tpu_torch.ops import attention as port

torch.set_num_threads(1)

# fp32 on both sides; the only difference is the summation order of the two
# einsums and the softmax, a few fp32 ulps of values of order 1
ATOL = 1e-5

SHAPES = [(1, 8, s, 32) for s in (7, 128, 240, 300)] + \
         [(2, 4, s, 64) for s in (7, 128, 240, 300)]
MASKS = ["none", "padded", "masked_row"]


@pytest.fixture
def interpret_mode():
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _inputs(shape, mask_kind, seed=0):
    rng = np.random.RandomState(seed)
    B, _, S, _ = shape
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    mask = None
    if mask_kind != "none":
        mask = np.ones((B, S), np.float32)
        mask[:, S - max(1, S // 4):] = 0  # trailing padding
        if mask_kind == "masked_row":
            mask[-1] = 0  # the last batch row attends to nothing
    return q, k, v, mask


def _port(q, k, v, mask, scale):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out, lse = port.flash_attention_fwd(t(q), t(k), t(v), t(mask), scale)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_attention_matches_jax_reference(shape, mask_kind):
    q, k, v, mask = _inputs(shape, mask_kind)
    scale = shape[-1] ** -0.5
    out, lse = _port(q, k, v, mask, scale)
    ref = _attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask),
                               scale)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    assert lse.shape == shape[:3] and np.isfinite(lse).all()
    if mask_kind == "masked_row":  # uniform weights: the mean of V
        np.testing.assert_allclose(out[-1], np.broadcast_to(
            v[-1].mean(axis=1, keepdims=True), out[-1].shape), atol=ATOL)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("shape", [(1, 8, 240, 32), (2, 4, 128, 64)], ids=str)
def test_plain_attention_matches_pallas_kernel(shape, mask_kind,
                                               interpret_mode):
    """Output against `flash_attention`, LSE against the fused kernel's."""
    q, k, v, mask = _inputs(shape, mask_kind, seed=1)
    scale = shape[-1] ** -0.5
    out, lse = _port(q, k, v, mask, scale)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    np.testing.assert_allclose(
        out, np.asarray(flash_attention(jq, jk, jv, jm, scale)), atol=ATOL)
    _, jlse = _fused_forward(jq, jk, jv, jm, scale)
    np.testing.assert_allclose(lse, np.asarray(jlse)[:, :, 0, :shape[2]],
                               atol=ATOL)


def test_wrapper_cpu_path_counts_no_launch():
    q, k, v, _ = _inputs((1, 8, 16, 32), "none")
    before = port.flash_attention_fwd.launches
    out = port.mha_with_flash(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    assert out.shape == (1, 8, 16, 32)
    assert port.flash_attention_fwd.launches == before


# gradients: the JAX test's own tolerance for its Pallas backward
# (`test_pallas.py:52-73`), fp32 sums in another order
GRAD_ATOL = 2e-5


def _jax_grads(q, k, v, mask, w, scale):
    jm = None if mask is None else jnp.asarray(mask)
    return jax.grad(
        lambda a, b, c: jnp.sum(flash_attention(a, b, c, jm, scale)
                                * jnp.asarray(w)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("shape", [(2, 8, 240, 32), (2, 2, 150, 64)], ids=str)
def test_flash_attention_grads_match_pallas(shape, mask_kind, interpret_mode):
    """The port's autograd Function (plain forward, plain LSE backward on
    CPU) against `jax.grad` of the Pallas kernel, with a non-uniform
    cotangent; "masked_row" gives the last batch row no key at all."""
    q, k, v, mask = _inputs(shape, mask_kind, seed=2)
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)
    scale = shape[-1] ** -0.5
    ref = _jax_grads(q, k, v, mask, w, scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.flash_attention(tq, tk, tv,
                               None if mask is None else torch.from_numpy(mask),
                               scale)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[:-1], want[:-1], atol=GRAD_ATOL,
                                   err_msg="d" + name)
        # a fully masked row's LSE, NEG_INF + log(Sk), rounds to NEG_INF in
        # fp32, so both packages give each of its keys p = 1, not 1/Sk: its
        # gradients are sums of Sk unnormalised terms (up to ~3 here), held
        # to the same 2e-5 relative to their size
        scale_row = max(1.0, float(np.abs(want[-1]).max()))
        np.testing.assert_allclose(got[-1], want[-1], atol=GRAD_ATOL * scale_row,
                                   err_msg="d" + name)


def test_backward_reference_matches_autograd_of_plain_forward():
    """Where every row sees a key, the LSE backward is the exact gradient:
    it equals autograd through `attention_reference`."""
    q, k, v, mask = _inputs((2, 4, 60, 32), "padded", seed=4)
    g = torch.randn(2, 4, 60, 32, generator=torch.Generator().manual_seed(0))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    m = torch.from_numpy(mask)
    out, lse = port.attention_reference(tq, tk, tv, m, 0.2)
    want = torch.autograd.grad(out, (tq, tk, tv), g)
    got = port.attention_backward_reference(tq.detach(), tk.detach(),
                                            tv.detach(), m, out.detach(),
                                            lse.detach(), g, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_wrapper_cpu_backward_counts_no_launch():
    q, k, v, _ = _inputs((1, 8, 16, 32), "none")
    before = (port.flash_attention_fwd.launches, port.flash_attention_bwd.launches)
    tq = torch.from_numpy(q).requires_grad_()
    port.mha_with_flash(tq, torch.from_numpy(k), torch.from_numpy(v)).sum().backward()
    assert tq.grad.shape == tq.shape
    assert (port.flash_attention_fwd.launches,
            port.flash_attention_bwd.launches) == before


def _bwd_args(shape=(1, 2, 8, 32), dtype=torch.float32, offset=0):
    """Backward inputs of `shape`; q starts `offset` elements into its
    storage (4 fp32: 16 bytes in; 2: 8 bytes, off csrc/flash_attn_bwd.cu's
    16-byte copies)."""
    B, H, S, d = shape
    n = B * H * S * d
    q = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    k, v, out, dout = (torch.zeros(shape, dtype=dtype) for _ in range(4))
    lse = torch.zeros(B, H, S)
    return q, k, v, None, out, lse, dout


BWD_REFUSALS = {  # case: (the arguments, what the refusal names)
    "q 8 bytes off": (_bwd_args(offset=2), "16-byte aligned"),
    "head width 16": (_bwd_args((1, 2, 8, 16)), "head width 16"),
    "fp16": (_bwd_args(dtype=torch.float16), "fp32 or bf16"),
    "lse shape": (_bwd_args()[:5] + (torch.zeros(1, 2, 7),) + _bwd_args()[6:],
                  "lse must be"),
}


@pytest.mark.parametrize("case", list(BWD_REFUSALS))
def test_backward_kernel_refuses_before_any_launch(monkeypatch, case):
    """What csrc/flash_attn_bwd.cu does not take (head widths other than 32
    and 64, types other than fp32 and bf16, tensors off the 16-byte alignment
    of its cp.async copies, misshapen LSE) is refused before the library is
    built or launched: the device test is forced to say "kernel" on these CPU
    tensors, and reaching the library fails the test."""
    def no_library(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setattr(port, "use_kernel", lambda *args: True)
    monkeypatch.setattr(port, "_library", no_library)
    args, match = BWD_REFUSALS[case]
    before = port.flash_attention_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        port.flash_attention_bwd(*args, 0.5)
    assert port.flash_attention_bwd.launches == before


def test_backward_kernel_takes_aligned_inputs(monkeypatch):
    """The same forced route with inputs the kernel takes (q 16 bytes into its
    storage) reaches the library: the refusals above are the wrapper's only
    ones."""
    reached = []

    def no_library(*args, **kwargs):
        reached.append(args)
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setattr(port, "use_kernel", lambda *args: True)
    monkeypatch.setattr(port, "_library", no_library)
    with pytest.raises(AssertionError, match="reached the kernel"):
        port.flash_attention_bwd(*_bwd_args(offset=4), 0.5)
    assert reached == [("flash_attn_bwd",)]
