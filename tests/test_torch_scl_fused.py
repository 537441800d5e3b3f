"""The port's fused SCL loss (`ops/scl.py`) against the JAX package's
`ops/scl_pallas.py` on the CPU: each pass's plain version against the
Pallas pass run in interpret mode (as `tests/test_pallas.py` runs them), the
loss and its gradient against `scl_loss_fused` + `jax.grad`; the port's
fused loss against its own plain `scl_sequence_loss`; the dispatch rule of
`algos/scl.py`, table-driven; the refusal of a width the kernels do not
take; the bounds `chip_smoke.py` reports.

Tolerances: fp32 on both sides, the same per-pair math summed in another
order over at most 160 x 160 pairs. Row sums of exp(l) (l <= 10) reach ~1e3:
1e-5 relative. The loss, a sum of KL terms of order 1: 1e-5 relative. The
gradient: 1e-6 absolute plus 1e-4 relative, as `test_fused_scl_grads_match_xla`
holds the Pallas backward against XLA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu.ops import scl_pallas as jax_fused
from video_rep_learning_tpu_torch.algos import scl as port_algo
from video_rep_learning_tpu_torch.algos.scl import (scl_loss_dispatch,
                                                    scl_sequence_loss,
                                                    use_fused_scl)
from video_rep_learning_tpu_torch.ops import bounds
from video_rep_learning_tpu_torch.ops import scl as port_fused

torch.set_num_threads(1)

TEMP, VAR = 0.1, 10.0
ROW_RTOL, LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-6, 1e-4
# (B, V, T, C): N = 160 and N = 74, neither a multiple of the 64-row tile
CASES = {"B2_T40": (2, 2, 40, 16), "B1_T37": (1, 2, 37, 32)}


def _inputs(case, seed=0):
    B, V, T, C = CASES[case]
    rng = np.random.RandomState(seed)
    embs = rng.randn(B, V, T, C).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    seq_lens = rng.randint(T, 3 * T, size=(B, V)).astype(np.float32)
    steps = np.sort(rng.randint(0, 2 * T, size=(B, V, T)), axis=-1).astype(np.float32)
    masks = np.ones((B, V, T), np.float32)
    masks[B - 1, 0, -5:] = 0  # masked frames in a view's tail
    masks[0, V - 1, 3] = 0    # and one inside a view
    return embs, seq_lens, steps, masks


def _flags(neg):
    return dict(single="single" in neg, noself="noself" in neg)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("neg", ["single_noself", "batch_noself"])
def test_passes_loss_and_grad_match_pallas(neg, case):
    embs, seq_lens, steps, masks = _inputs(case)
    B, V, T, C = embs.shape
    N = B * V * T
    params = dict(temperature=TEMP, label_varience=VAR, **_flags(neg))

    # the Pallas passes: `_fused_forward`'s row sums, then the loss and S
    # passes on them as `_fused_forward` / `_fused_backward` chain them
    je = jnp.asarray(embs).reshape(N, C)
    jmeta = jax_fused._build_meta(*(jnp.asarray(a) for a in (seq_lens, steps, masks)))
    _, rows, _ = jax_fused._fused_forward(je, jmeta, **params)
    bI, bJ, nI, nJ, jNp = jax_fused._block_layout(N, C, 512)
    je, jmeta = jax_fused._pad_inputs(je, jmeta, jNp)
    spec = [jax_fused.pl.BlockSpec((bI, jax_fused._LANES), lambda i, j: (i, 0))]
    loss_rows = jax_fused._row_pass(jax_fused._loss_kernel, je, jmeta, [rows], spec,
                                    jax_fused._LANES, params, bI, bJ, nI, nJ, jNp, C)
    s_rows = jax_fused._row_pass(jax_fused._srow_kernel, je, jmeta, [rows], spec,
                                 jax_fused._LANES, params, bI, bJ, nI, nJ, jNp, C)
    args = tuple(jnp.asarray(a) for a in (seq_lens, steps, masks))
    ref_loss, ref_grad = jax.value_and_grad(
        lambda e: jax_fused.scl_loss_fused(e, *args, TEMP, VAR, neg))(jnp.asarray(embs))

    # the port's passes on its own padding (Np a multiple of 64)
    e = torch.from_numpy(embs).reshape(N, C)
    meta = port_fused.build_meta(*(torch.from_numpy(a) for a in (seq_lens, steps, masks)))
    Np = port_fused.block_layout(N)
    assert Np % port_fused.TILE == 0 and Np > N
    e, meta = port_fused.pad_inputs(e, meta, Np)
    np.testing.assert_array_equal(meta[:, :N].numpy(), np.asarray(jmeta)[:, :N])
    got_rows = port_fused.scl_rowsum(e, meta, **params)
    got_loss_rows = port_fused.scl_loss_rows(e, meta, got_rows, **params)
    got_s = port_fused.scl_srow(e, meta, got_rows, **params)
    want_rows = np.asarray(rows)
    np.testing.assert_allclose(got_rows[:N].numpy(), want_rows[:N, :2], rtol=ROW_RTOL)
    np.testing.assert_allclose(got_loss_rows[:N].numpy(), np.asarray(loss_rows)[:N, 0],
                               rtol=ROW_RTOL, atol=1e-5)
    np.testing.assert_allclose(got_s[:N].numpy(), np.asarray(s_rows)[:N, 0],
                               rtol=ROW_RTOL, atol=1e-6)
    # padding rows take part in nothing
    for t in (got_rows, got_loss_rows, got_s):
        assert not t[N:].any()

    te = torch.from_numpy(embs).requires_grad_()
    loss = port_fused.scl_loss_fused(te, *(torch.from_numpy(a) for a in
                                           (seq_lens, steps, masks)), TEMP, VAR, neg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ref_grad),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("neg", ["single_noself", "batch_noself", "single", "batch"])
def test_fused_matches_plain_sequence_loss(neg):
    """The port's fused loss and gradient against its own plain composition
    (the path `scl_loss_dispatch` takes below the gate)."""
    embs, seq_lens, steps, masks = _inputs("B2_T40", seed=1)
    aux = [torch.from_numpy(a) for a in (seq_lens, steps, masks)]
    got_e = torch.from_numpy(embs).requires_grad_()
    got = port_fused.scl_loss_fused(got_e, *aux, TEMP, VAR, neg)
    got.backward()
    want_e = torch.from_numpy(embs).requires_grad_()
    want = scl_sequence_loss(want_e, *aux, temperature=TEMP, label_varience=VAR,
                             positive_type="gauss", negative_type=neg)["loss"]
    want.backward()
    np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_e.grad.numpy(), want_e.grad.numpy(),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_backward_stays_finite_where_positives_underflow():
    """A frame whose timeline maps far past the other view's unmasked frames
    (here 43 steps, into its masked tail) has possum = exp(-43^2 / 20) ~
    7e-41, subnormal. Where subnormals are kept (torch on the CPU, CUDA
    without fast math), the Pallas backward's 1 / possum would overflow to
    inf (XLA flushes the subnormal to 0 instead); the port divides, as the
    forward does, and matches the plain composition's autograd."""
    T, C = 8, 16
    rng = np.random.RandomState(3)
    embs = rng.randn(1, 2, T, C).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    seq_lens = np.full((1, 2), 100, np.float32)
    steps = np.stack([np.arange(T), np.r_[np.arange(T - 1), 46]])[None].astype(np.float32)
    masks = np.ones((1, 2, T), np.float32)
    masks[0, 0, 4:] = 0
    args = [torch.from_numpy(a) for a in (seq_lens, steps, masks)]
    got_e = torch.from_numpy(embs).requires_grad_()
    port_fused.scl_loss_fused(got_e, *args, TEMP, VAR, "single_noself").backward()
    want_e = torch.from_numpy(embs).requires_grad_()
    scl_sequence_loss(want_e, *args, temperature=TEMP, label_varience=VAR,
                      negative_type="single_noself")["loss"].backward()
    assert torch.isfinite(got_e.grad).all()
    np.testing.assert_allclose(got_e.grad.numpy(), want_e.grad.numpy(),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    possum = port_fused.scl_rowsum(
        *port_fused.pad_inputs(got_e.detach().reshape(2 * T, C),
                               port_fused.build_meta(*args), 64),
        temperature=TEMP, label_varience=VAR, single=True, noself=True)[2 * T - 1, 1]
    assert 0 < possum.item() < torch.finfo(torch.float32).tiny


# (positive type, device, VRL_FUSED_SCL, N) -> fused?
DISPATCH = [
    ("gauss", "cuda", "auto", 8191, False),
    ("gauss", "cuda", "auto", 8192, True),
    ("gauss", "cuda", "1", 480, True),
    ("gauss", "cuda", "1", 8192, True),
    ("gauss", "cuda", "0", 8192, False),
    ("gauss", "cuda", "0", 480, False),
    ("gauss", "cpu", "1", 480, False),
    ("gauss", "cpu", "auto", 8192, False),
    ("none", "cuda", "1", 480, False),
    ("none", "cuda", "auto", 8192, False),
]


@pytest.mark.parametrize("positive, device, flag, n, fused", DISPATCH,
                         ids=["-".join(map(str, c[:4])) for c in DISPATCH])
def test_dispatch_rule(positive, device, flag, n, fused):
    assert use_fused_scl(positive, device, n, flag) is fused


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_dispatch_reads_the_environment(env, monkeypatch):
    """`scl_loss_dispatch` reads VRL_FUSED_SCL (default auto) and counts N =
    B*V*T; with the rule forced on it returns the fused loss, else the plain
    one, and both agree."""
    if env is None:
        monkeypatch.delenv("VRL_FUSED_SCL", raising=False)
    else:
        monkeypatch.setenv("VRL_FUSED_SCL", env)
    seen = []

    def spy(positive, device, n, flag):
        seen.append((positive, device, n, flag))
        return flag == "1"

    monkeypatch.setattr(port_algo, "use_fused_scl", spy)
    embs, seq_lens, steps, masks = (torch.from_numpy(a) for a in _inputs("B1_T37"))
    kw = dict(temperature=TEMP, label_varience=VAR, positive_type="gauss",
              negative_type="single_noself")
    got = scl_loss_dispatch(embs, seq_lens, steps, masks, **kw)
    assert seen == [("gauss", "cpu", 74, env or "auto")]
    want = scl_sequence_loss(embs, seq_lens, steps, masks, **kw)["loss"]
    np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)


@pytest.mark.parametrize("C", [8, 24, 144])
def test_unsupported_width_raises(C):
    e = torch.zeros(64, C)
    meta = torch.zeros(8, 64)
    with pytest.raises(ValueError, match=r"C % 16 == 0 and 16 <= C <= 128"):
        port_fused.scl_rowsum(e, meta, temperature=TEMP, label_varience=VAR,
                              single=True, noself=True)
    with pytest.raises(ValueError, match=f"got C={C}"):
        port_fused.scl_loss_fused(torch.zeros(1, 2, 32, C), torch.ones(1, 2),
                                  torch.zeros(1, 2, 32), torch.ones(1, 2, 32),
                                  TEMP, VAR, "single_noself")


def test_bounds_count_forward_and_backward():
    """`bounds.scl_fused`: the forward's products are the logits, the
    backward's the logits and (G + G^T) e; both are bound by operations at
    the fp32 rate, and fewer pairs bound less work. The loss and S passes
    count the positives only, the row-sum and gradient passes every pair."""
    N, C = 8640, 128
    work = bounds.scl_fused(N, C)
    fwd, bwd = (bounds.bound(*work[k]) for k in ("forward", "backward"))
    assert fwd[1] == bwd[1] == "operations"
    assert work["forward"][1] == 2 * N * N * C
    assert work["backward"][1] == 4 * N * N * C
    assert bwd[0] > fwd[0] > 0
    assert set(work) >= {"rowsum", "loss", "srow", "grad"}
    half = bounds.scl_fused(N, C, pairs=N * N // 2)
    assert bounds.bound(*half["forward"])[0] < fwd[0]
    few = bounds.scl_fused(N, C, pairs=N * N // 2, positives=N * N // 8)
    for k in ("loss", "srow"):
        assert few[k][1] == 2 * C * N * N // 8
        assert bounds.bound(*few[k])[0] < bounds.bound(*half[k])[0]
    for k in ("rowsum", "grad", "forward", "backward"):
        assert few[k][1] == half[k][1]
        assert few[k][3] < half[k][3]


@pytest.mark.parametrize("neg", ["single_noself", "batch_noself"])
def test_work_pairs_hold_every_nonzero_term(neg):
    """`work_pairs`, whose counts `chip_smoke.py` passes to the bounds: every
    pair with a nonzero negative term or positive is in `pairs`, and every
    nonzero positive (so every nonzero label, loss and S term) in
    `positives`, a strict subset."""
    embs, seq_lens, steps, masks = (torch.from_numpy(a) for a in _inputs("B2_T40"))
    B, V, T, C = embs.shape
    N = B * V * T
    e, meta = port_fused.pad_inputs(embs.reshape(N, C), port_fused.build_meta(
        seq_lens, steps, masks), port_fused.block_layout(N))
    params = dict(temperature=TEMP, label_varience=VAR, **_flags(neg))
    pairs, positives = port_fused.work_pairs(meta, **_flags(neg))
    el, w, pos, _, cross = port_fused.tile_terms(e, e, meta, meta, **params)
    assert not (w * el)[~pairs].any() and not pos[~pairs].any()
    assert not pos[~positives].any()
    assert (positives <= pairs).all() and 0 < positives.sum() < pairs.sum()
    assert positives.sum() < cross.sum()  # masked frames carry no label


# (B, T, masked frames): clips that share a tile with their neighbours, a
# K400-like batch of many short clips, and clips with no masked frame
TILE_CASES = {"3 clips, masked": (3, 40, True), "18 clips, masked": (18, 24, True),
              "2 clips, none masked": (2, 70, False)}


@pytest.mark.parametrize("neg", ["single_noself", "batch_noself", "single_self", "batch_self"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tiles_hold_every_work_pair(case, neg):
    """`scl_tiles`, the flags the kernels skip tiles by, from per-tile counts:
    every pair `work_pairs` counts lies in a tile flagged for passes 1 and 4,
    every positive in one flagged for passes 2 and 3, and a tile is dropped
    only where it holds no such pair (the flags equal `tiles_reference`'s,
    taken from `work_pairs` tile by tile). Under single_noself most of a
    multi-clip batch is skipped; under batch_noself only the tiles inside
    one view of one clip and the padding are."""
    B, T, masked = TILE_CASES[case]
    e4, lens, steps, masks = port_fused.sample_inputs(B, T, seed=B)
    if not masked:
        masks = torch.ones_like(masks)
    N, TILE = B * 2 * T, port_fused.TILE
    meta = port_fused.pad_inputs(e4.reshape(N, -1), port_fused.build_meta(lens, steps, masks),
                                 port_fused.block_layout(N))[1]
    tiles = port_fused.scl_tiles(meta, B, 2, **_flags(neg))
    nT = meta.shape[1] // TILE
    assert tiles.shape == (nT, nT) and tiles.dtype == torch.uint8
    pairs, positives = port_fused.work_pairs(meta, **_flags(neg))
    for bit, need in ((1, pairs), (2, positives)):
        flagged = (tiles & bit).bool().repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
        assert not need[~flagged].any()  # every pair in a flagged tile
        holds = need.view(nT, TILE, nT, TILE).any(3).any(1)
        assert torch.equal((tiles & bit).bool(), holds)  # only empty tiles dropped
    assert torch.equal(tiles, port_fused.tiles_reference(meta, **_flags(neg)))
    kept = (tiles & 1).float().mean().item()
    if neg == "single_noself" and B == 18:
        assert kept < 0.5
    if neg == "batch_noself":
        assert kept > 0.75
