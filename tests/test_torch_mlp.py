"""Kernels #7 and #9 of the ViT MLP, and the gradients through every ViT
kernel: the plain versions of matmul + bias + GELU
(`matmul_bias_gelu_reference`) and of the whole LN-MLP half-block
(`ln_mlp_block_reference`) against the JAX package's Pallas kernels
(`matmul_gelu_pallas.py` `_kernel`, `_kernel_mlp`) run in interpret mode
with the TPU gates forced on, as `tests/test_torch_vit.py` runs #6; then
the gradients of the port's wrappers of #7, #9, #4 (packed attention), #5
(the attention half-block), #6 (LN + matmul + GELU) and #8 (LayerNorm) —
their autograd Functions, forward the kernel (the plain version here),
backward autograd of the plain version chunked over frames — against
`jax.grad` through the JAX wrappers, whose custom_vjps differentiate the
same plain compositions. At dim 128, F 512, N 17 and 130, fp32 and bf16,
erf and tanh GELU.

Tolerances, as max |port - JAX|:
- fp32 values: the same fp32 math summed in another order (values of
  order 1-10, 128- and 512-term sums, ~1e-6), plus the TPU kernel's erf:
  the A&S polynomial (1.5e-7, GELU within 2e-6) where the plain version
  uses torch's erf: 5e-6.
- bf16 values: both sides round at the same points (the LN output, the
  activation before fc2, the output), so a value differs only where the
  fp32 values on the two sides fall either side of a rounding boundary:
  one bf16 ulp of the output's largest value (2^-7 of it) for #7. #9 rounds
  twice: an activation one ulp apart moves fc2's sum by far less than an
  ulp of the output, which then rounds once more: two ulps. (The TPU
  kernel's bf16 exact GELU uses a tanh-fitted erf, 3.3e-6 off, far under
  an ulp.)
- fp32 gradients: autograd of the same plain composition on both sides,
  the port's summed over frame chunks: 1e-5 of each gradient tensor's
  largest value (at least 1).
- bf16 gradients: both sides round each gradient to bf16, JAX once over
  all frames, the port once a chunk (then sums the chunks in fp32), and
  both round p, the activation and the LN output on the way: 2^-6 of each
  tensor's largest value (two bf16 ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu.ops import attention_pallas as jax_attn
from video_rep_learning_tpu.ops import layernorm_pallas as jax_ln
from video_rep_learning_tpu.ops import matmul_gelu_pallas as jax_mm
from video_rep_learning_tpu.ops import vit_block_pallas as jax_vb
from video_rep_learning_tpu_torch.ops import matmul, plain_grad
from video_rep_learning_tpu_torch.ops.attention import packed_vit_attention
from video_rep_learning_tpu_torch.ops.layernorm import fused_layernorm
from video_rep_learning_tpu_torch.ops.matmul import (
    ln_matmul_bias_act, ln_matmul_bias_act_reference, ln_mlp_block,
    ln_mlp_block_reference, matmul_bias_gelu, matmul_bias_gelu_reference)
from video_rep_learning_tpu_torch.ops.vit_block import vit_attention_block

torch.set_num_threads(1)

D, FH, HEADS = 128, 512, 2
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
FP32_ATOL = 5e-6
BF16_ULPS = {"mm": 1, "mlp": 2}
GRAD_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -6}
ACTS = {"gelu_exact": False, "gelu_tanh": True}


@pytest.fixture
def tpu_interpret(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        yield


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _port(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][0])


def _jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def _check(kind, dtype, got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    tol = (FP32_ATOL if dtype == "fp32" else
           BF16_ULPS[kind] * 2.0 ** -7 * max(1.0, float(np.abs(want).max())))
    err = float(np.abs(got - want).max())
    assert err <= tol, (kind, dtype, err, tol)


def _mlp_args(rng, N, B=2):
    x = _rand(rng, B, N, D, scale=2.0, shift=0.5)
    g, be = _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1)
    w1, b1 = _rand(rng, FH, D, scale=0.05), _rand(rng, FH, scale=0.05)
    w2, b2 = _rand(rng, D, FH, scale=0.05), _rand(rng, D, scale=0.05)
    return x, g, be, w1, b1, w2, b2


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matmul_bias_gelu_plain_matches_pallas(tpu_interpret, dtype, N, activation):
    rng = np.random.RandomState(N + 7)
    x = _rand(rng, 2, N, D, scale=2.0, shift=0.5)
    w, b = _rand(rng, FH, D, scale=0.05), _rand(rng, FH, scale=0.05)
    approx = ACTS[activation]
    want = jax_mm.matmul_bias_gelu(_jax(x, dtype), jnp.asarray(w.T),
                                   jnp.asarray(b), approximate=approx)
    got = matmul_bias_gelu(_port(x, dtype), _port(w, dtype), torch.from_numpy(b),
                           approx)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (2, N, FH)
    _check("mm", dtype, got, want)
    # the plain version is the LN-off route of #6's
    np.testing.assert_array_equal(
        got.float().numpy(),
        ln_matmul_bias_act_reference(_port(x, dtype), None, None, _port(w, dtype),
                                     torch.from_numpy(b), activation).float().numpy())


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ln_mlp_block_plain_matches_pallas(tpu_interpret, dtype, N, activation):
    rng = np.random.RandomState(N + 8)
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, N)
    j, t = jnp.asarray, torch.from_numpy
    want = jax_mm.ln_mlp_block(_jax(x, dtype), j(g), j(be), j(w1.T), j(b1),
                               j(w2.T), j(b2), activation)
    got = ln_mlp_block(_port(x, dtype), t(g), t(be), _port(w1, dtype), t(b1),
                       _port(w2, dtype), t(b2), activation)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (2, N, D)
    _check("mlp", dtype, got, want)


def _grads_close(dtype, got, want):
    for name, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape, name
        tol = GRAD_TOL[dtype] * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol, (name, dtype, err, tol)


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matmul_bias_gelu_gradient_matches_jax(tpu_interpret, dtype, activation):
    rng = np.random.RandomState(9)
    x = _rand(rng, 3, 17, D, scale=2.0, shift=0.5)
    w, b = _rand(rng, FH, D, scale=0.05), _rand(rng, FH, scale=0.05)
    ct = _rand(rng, 3, 17, FH)
    approx = ACTS[activation]

    def loss(x, w, b):
        y = jax_mm.matmul_bias_gelu(x, w, b, approximate=approx)
        return jnp.sum(y.astype(jnp.float32) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(_jax(x, dtype), _jax(w.T, dtype),
                                             jnp.asarray(b))
    xp = _port(x, dtype).requires_grad_()
    wp = _port(w, dtype).requires_grad_()
    bp = torch.from_numpy(b).requires_grad_()
    y = matmul_bias_gelu(xp, wp, bp, approx, grad_chunk=2)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xp.grad.dtype == xp.dtype and wp.grad.dtype == wp.dtype
    _grads_close(dtype, (xp.grad, wp.grad.t(), bp.grad), want)


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ln_mlp_block_gradient_matches_jax(tpu_interpret, dtype, activation):
    rng = np.random.RandomState(10)
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, 17, B=3)
    ct = _rand(rng, 3, 17, D)

    def loss(x, g, be, w1, b1, w2, b2):
        y = jax_mm.ln_mlp_block(x, g, be, w1, b1, w2, b2, activation)
        return jnp.sum(y.astype(jnp.float32) * ct)

    j = jnp.asarray
    want = jax.grad(loss, argnums=tuple(range(7)))(
        _jax(x, dtype), j(g), j(be), _jax(w1.T, dtype), j(b1), _jax(w2.T, dtype),
        j(b2))
    t = torch.from_numpy
    args = [_port(x, dtype), t(g), t(be), _port(w1, dtype), t(b1),
            _port(w2, dtype), t(b2)]
    for a in args:
        a.requires_grad_()
    y = ln_mlp_block(*args, activation, grad_chunk=2)
    (y.float() * t(ct)).sum().backward()
    got = [a.grad for a in args]
    got[3], got[5] = got[3].t(), got[5].t()
    _grads_close(dtype, got, want)


# ---------------------------------------------------------------------------
# the gradients of #4, #5, #6 and #8
# ---------------------------------------------------------------------------

def _kernel_case(name, rng):
    """(JAX function of the differentiable args, port function, args as
    numpy in the port's layout, transposed positions) for one kernel."""
    x = _rand(rng, 3, 17, D, scale=2.0, shift=0.5)
    g, be = _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1)
    if name == "layernorm":
        return (lambda x, g, be: jax_ln.fused_layernorm(x, g, be),
                lambda x, g, be: fused_layernorm(x, g, be, grad_chunk=2),
                [(x, True), (g, False), (be, False)], ())
    if name == "ln_gemm":
        w, b = _rand(rng, 4 * D, D, scale=0.05), _rand(rng, 4 * D, scale=0.05)
        return (lambda x, g, be, w, b: jax_mm.ln_matmul_bias_act(
                    x, g, be, w, b, "gelu_exact"),
                lambda x, g, be, w, b: ln_matmul_bias_act(
                    x, g, be, w, b, "gelu_exact", grad_chunk=2),
                [(x, True), (g, False), (be, False), (w, True), (b, False)], (3,))
    if name == "packed_attn":
        return (lambda q: jax_attn.packed_vit_attention(q, HEADS),
                lambda q: packed_vit_attention(q, HEADS, grad_chunk=2),
                [(_rand(rng, 3, 17, 3 * D), True)], ())
    wqkv, bqkv = _rand(rng, 3 * D, D, scale=0.05), _rand(rng, 3 * D, scale=0.05)
    wp, bp = _rand(rng, D, D, scale=0.05), _rand(rng, D, scale=0.05)
    return (lambda *a: jax_vb.vit_attention_block(*a, HEADS),
            lambda *a: vit_attention_block(*a, HEADS, grad_chunk=2),
            [(x, True), (g, False), (be, False), (wqkv, True), (bqkv, False),
             (wp, True), (bp, False)], (3, 5))


@pytest.mark.parametrize("name", ["layernorm", "ln_gemm", "packed_attn",
                                  "vit_attention_block"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vit_kernel_gradient_matches_jax(tpu_interpret, name, dtype):
    rng = np.random.RandomState(30)
    jfn, pfn, args, transposed = _kernel_case(name, rng)
    jt, tt = DTYPES[dtype][1], DTYPES[dtype][0]
    jargs = [jnp.asarray(a.T if i in transposed else a).astype(jt if typed else jnp.float32)
             for i, (a, typed) in enumerate(args)]
    pargs = [torch.from_numpy(a).to(tt if typed else torch.float32).requires_grad_()
             for a, typed in args]
    out_shape = pfn(*[p.detach() for p in pargs]).shape
    ct = _rand(rng, *out_shape)

    def loss(*a):
        return jnp.sum(jfn(*a).astype(jnp.float32) * ct)

    want = jax.grad(loss, argnums=tuple(range(len(args))))(*jargs)
    y = pfn(*pargs)
    assert y.dtype == tt and y.requires_grad
    (y.float() * torch.from_numpy(ct)).sum().backward()
    got = [p.grad.t() if i in transposed else p.grad for i, p in enumerate(pargs)]
    assert all(g.dtype == p.dtype for g, p in zip(got, pargs))
    _grads_close(dtype, got, want)


def test_plain_grad_chunks_sum_to_the_whole():
    """The chunked backward equals autograd of the plain version over all
    frames at once (fp32; only the sums' order differs), for the frame
    input and every parameter."""
    rng = np.random.RandomState(11)
    t = torch.from_numpy
    args = [t(a) for a in _mlp_args(rng, 9, B=5)]
    whole = [a.clone().requires_grad_() for a in args]
    ln_mlp_block_reference(*whole).square().sum().backward()
    for chunk in (1, 2, 5, None):
        chunked = [a.clone().requires_grad_() for a in args]
        before = matmul.ln_mlp_block.launches
        ln_mlp_block(*chunked, grad_chunk=chunk).square().sum().backward()
        assert matmul.ln_mlp_block.launches == before  # CPU: no launch
        for a, b in zip(chunked, whole):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_launch_with_grad_outside_the_function_raises():
    """A kernel launch would drop the gradient: with grad on and an input
    that requires grad, the launching path refuses before it looks at the
    device (checked here on the meta device; `tests/test_torch_cuda.py`
    checks it on the card)."""
    x = torch.empty(2, 3, D, device="meta", requires_grad=True)
    w, b = torch.empty(FH, D, device="meta"), torch.empty(FH, device="meta")
    with pytest.raises(RuntimeError, match="records no gradient"):
        matmul._matmul_bias_gelu(x, w, b, False)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        matmul._matmul_bias_gelu(x, w, b, False)
    assert plain_grad.needs_grad(x) and not plain_grad.needs_grad(x.detach())


# what csrc/mlp_block.cu does not take: (K, F, activation, bf16 x 2 bytes
# past a 16 B boundary), and the error the wrapper names it with
BAD_MLP = {"K192": ((192, 768, "gelu_exact", False), "K=192"),
           "K896": ((896, 256, "gelu_exact", False), "K=896"),
           "F96": ((128, 96, "gelu_exact", False), "F=96"),
           "misaligned": ((128, 512, "gelu_exact", True), "16-byte aligned"),
           "activation": ((128, 512, "relu", False), "relu")}


@pytest.mark.parametrize("case", list(BAD_MLP))
def test_ln_mlp_block_refuses_before_any_launch(monkeypatch, case):
    """The wrapper of #9 checks what `csrc/mlp_block.cu` takes (K a multiple
    of 128 up to 768, F a multiple of 64, a 16 B aligned x, a known
    activation) before it builds or launches anything: here the device test
    is forced to say "kernel" on CPU tensors and any build or launch fails
    the test."""
    def no_launch(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setattr(matmul, "use_kernel", lambda *args: True)
    monkeypatch.setattr(matmul.cuda_build, "kernel_fn", no_launch)
    (K, F, act, misaligned), match = BAD_MLP[case]
    bf = torch.bfloat16
    x = torch.zeros(2 * 3 * K + 1, dtype=bf)[int(misaligned):][:2 * 3 * K].view(2, 3, K)
    w1, w2 = torch.zeros(F, K, dtype=bf), torch.zeros(K, F, dtype=bf)
    ones_k = torch.ones(K)
    before = matmul.ln_mlp_block.launches
    with pytest.raises(ValueError, match=match):
        ln_mlp_block(x, ones_k, ones_k, w1, torch.ones(F), w2, ones_k, act)
    assert matmul.ln_mlp_block.launches == before
