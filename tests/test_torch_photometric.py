"""The port's SSL augmentation against the JAX package's: the plain versions
of the crop+photometric and photometric kernels against the Pallas kernels
run in interpret mode (as `tests/test_pallas.py` runs them on the CPU), fed
the same numpy flags, op orders and matrices; the matrix builders and the
crop box; the compact forms the CUDA kernel takes; and the whole two-view
augmentation from the same sampled values."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu.ops import augment as jaug
from video_rep_learning_tpu.ops import photometric_pallas as jpal
from video_rep_learning_tpu_torch.ops import augment as aug
from video_rep_learning_tpu_torch.ops import photometric as ph

torch.set_num_threads(1)

# the JAX test's own tolerance for these kernels (`test_pallas.py:247`):
# fp32 on both sides, sums (resample, blur, contrast mean) in another order,
# then /0.224 in the normalisation
ATOL = 3e-5
S, H, W = 32, 40, 44


def taps_to_matrix(idx, w, n):
    """Inverse of `resample_taps`: the dense (..., S, n) matrix."""
    m = torch.zeros(idx.shape + (n,), dtype=torch.float32, device=idx.device)
    m.scatter_(-1, idx[..., None].long(), w[..., :1])
    m.scatter_add_(-1, idx[..., None].long() + 1, w[..., 1:])
    return m


def stencil_band_matrix(taps, size: int):
    """(size, size) M with M[src, dst] = sum of taps[k] over the k whose
    reflected source index dst + k - c is src (torch 'reflect' padding)."""
    k = taps.shape[-1]
    c = (k - 1) // 2
    dst = torch.arange(size)
    src = dst[None, :] + torch.arange(k)[:, None] - c
    src = torch.where(src < 0, -src, src)
    src = torch.where(src >= size, 2 * (size - 1) - src, src)
    m = torch.zeros(size, size, dtype=torch.float32)
    m.index_put_((src.reshape(-1), dst.repeat(k)),
                 taps[:, None].expand(k, size).reshape(-1).float(),
                 accumulate=True)
    return m


@pytest.fixture
def interpret_mode():
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _case(kind, seed):
    """Per-view (fscal, orders, boxes, sigmas) for 4 views. `orders` puts
    contrast at each of the four positions, one per view."""
    rng = np.random.RandomState(seed)
    BV = 4
    f = np.zeros((BV, 8), np.float32)
    f[:, 1:4] = rng.uniform(0.2, 1.8, (BV, 3))
    f[:, 4] = rng.uniform(-0.2, 0.2, BV)
    if kind == "all":        # every flag on
        f[:, [0, 5, 6, 7]] = 1
    elif kind == "none":     # crop and normalisation only
        pass
    else:                    # flags drawn per view
        f[:, [0, 5, 6, 7]] = rng.rand(BV, 4) < 0.5
        f[0, [0, 5]] = 1, 0  # jitter without blur
        f[1, [0, 5]] = 0, 1  # blur without jitter
    orders = np.stack([np.roll([1, 0, 2, 3], i) for i in range(BV)]).astype(np.int32)
    sigmas = np.array([0.1, 2.0, 0.7, 1.3], np.float32)
    boxes = np.array([[0, 0, 40, 36], [3, 5, 33, 30], [1, 2, 36, 34],
                      [4, 0, 30, 31]], np.float32)  # inside true (40, 36)
    return f, orders, boxes, sigmas


def _jax_matrices(boxes, sigmas):
    rh = np.stack([np.asarray(jaug._rrc_matrix(H, S, jnp.float32(b[2]), jnp.float32(b[0])))
                   for b in boxes])
    rw = np.stack([np.asarray(jaug._rrc_matrix(W, S, jnp.float32(b[3]), jnp.float32(b[1]))).T
                   for b in boxes])
    mh = np.stack([np.asarray(jpal.blur_band_matrix(S, 9, jnp.float32(s))).T for s in sigmas])
    mw = np.stack([np.asarray(jpal.blur_band_matrix(S, 5, jnp.float32(s))) for s in sigmas])
    return rh, rw, mh, mw


def _canvas(T, seed):
    """(4, T, 3, H, W) uint8 frames whose true extent is (40, 36): the rest
    of the canvas is padding."""
    v = np.random.RandomState(seed).randint(0, 256, (4, T, 3, H, W)).astype(np.uint8)
    v[..., 36:] = 0
    return v


@pytest.mark.parametrize("kind", ["all", "none", "mixed"])
@pytest.mark.parametrize("T", [1, 3])
def test_crop_photometric_plain_matches_pallas(kind, T, interpret_mode):
    f, orders, boxes, sigmas = _case(kind, seed=T)
    rh, rw, mh, mw = _jax_matrices(boxes, sigmas)
    v = _canvas(T, seed=T)
    ref = jpal.fused_crop_photometric(
        jax.lax.bitcast_convert_type(jnp.asarray(v), jnp.int8), jnp.asarray(rh),
        jnp.asarray(rw), jnp.asarray(f), jnp.asarray(orders), jnp.asarray(mh),
        jnp.asarray(mw))
    t = torch.from_numpy
    out = ph.crop_photometric(t(v), t(rh), t(rw), t(f), t(orders), t(mh), t(mw))
    assert out.shape == (4, T, 3, S, S) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["all", "mixed"])
def test_photometric_plain_matches_pallas(kind, interpret_mode):
    f, orders, _, sigmas = _case(kind, seed=5)
    _, _, mh, mw = _jax_matrices(_case(kind, 5)[2], sigmas)
    x = np.random.RandomState(6).rand(4, 3, 3, S, S).astype(np.float32)
    ref = jpal.fused_photometric(jnp.asarray(x), jnp.asarray(f),
                                 jnp.asarray(orders), jnp.asarray(mh),
                                 jnp.asarray(mw))
    t = torch.from_numpy
    out = ph.photometric(t(x), t(f), t(orders), t(mh), t(mw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_bf16_output_is_the_rounded_fp32_output():
    f, orders, boxes, sigmas = _case("all", seed=2)
    t = torch.from_numpy
    args = [t(a) for a in _jax_matrices(boxes, sigmas)]
    v = t(_canvas(3, seed=2))
    rh, rw, mh, mw = args
    out32 = ph.crop_photometric(v, rh, rw, t(f), t(orders), mh, mw)
    out16 = ph.crop_photometric(v, rh, rw, t(f), t(orders), mh, mw,
                                out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))


def test_hue_edge_cases():
    """Grey pixels (delta == 0 keeps h = 0) and a hue that lands on 1.0 after
    the shift (sextant 6 wraps to 0), against the JAX kernel's `_hue`."""
    x = np.array([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                  [0.2, 0.9, 0.4], [1.0, 1.0, 0.0]], np.float32)
    x = np.ascontiguousarray(x.T.reshape(1, 3, 1, 5))
    for f in (0.0, 0.2, -0.2, 1.0 - 1e-8, 0.5):
        ref = jpal._hue(jnp.asarray(x[0]), jnp.float32(f))
        out = ph._hue(torch.from_numpy(x), torch.tensor(f, dtype=torch.float32))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("n_in", [40, 44, 256])
def test_rrc_matrix_matches_jax(n_in):
    rng = np.random.RandomState(n_in)
    for _ in range(20):
        length = np.float32(rng.randint(max(2, n_in // 2), n_in + 1))
        offset = np.float32(rng.randint(0, n_in - length + 1))
        ref = np.asarray(jaug._rrc_matrix(n_in, 32, jnp.float32(length),
                                          jnp.float32(offset)))
        out = aug._rrc_matrix(n_in, 32, length, offset).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("ksize", [9, 5])
def test_blur_band_matrix_matches_jax(ksize):
    for sigma in (0.1, 0.55, 1.3, 2.0):
        ref = np.asarray(jpal.blur_band_matrix(S, ksize, jnp.float32(sigma)))
        out = aug.blur_band_matrix(S, ksize, np.float32(sigma)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-7)


def test_rrc_box_matches_jax():
    """The same uniforms through both packages' box arithmetic, canvases
    that take the attempts and ones that take the central fallback."""
    for seed in range(30):
        key = jax.random.key(seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        for hw in ((256.0, 256.0), (40.0, 36.0), (30.0, 200.0), (200.0, 30.0)):
            ref = jaug.sample_rrc_box(key, *hw)
            uniforms = (
                torch.from_numpy(np.array(jax.random.uniform(k1, (10,), minval=0.8, maxval=1.0))),
                torch.from_numpy(np.array(jax.random.uniform(
                    k2, (10,), minval=np.log(3 / 4), maxval=np.log(4 / 3)))),
                torch.tensor(float(jax.random.uniform(k3, ()))),
                torch.tensor(float(jax.random.uniform(k4, ()))))
            out = aug.rrc_box(uniforms, *hw)
            np.testing.assert_array_equal(np.array([float(o) for o in out]),
                                          np.array([float(r) for r in ref]))


def test_resample_taps_are_exact():
    """The kernel reads each resample row as two adjacent taps: for random
    crop boxes (and the whole canvas) every row of rh and every column of rw
    has at most two non-zero weights, and the taps rebuild the matrix
    exactly."""
    gen = torch.Generator().manual_seed(0)
    p = aug.AugmentParams(image_size=224)
    for H_, W_ in ((256, 256), (240, 320), (200, 180)):
        s = aug.sample_ssl_batch(gen, 4, 2, H_, W_, None, p)
        for m, n in ((s["rh"], H_), (s["rw"].transpose(1, 2), W_)):
            assert int((m != 0).sum(-1).max()) <= 2
            idx, w = ph.resample_taps(m)
            assert torch.equal(taps_to_matrix(idx, w, n), m)


def test_blur_taps_rebuild_band_matrices():
    gen = torch.Generator().manual_seed(1)
    s = aug.sample_ssl_batch(gen, 2, 2, 64, 64, None, aug.AugmentParams(image_size=S))
    wy, wx = ph.blur_taps(s["mh"], s["mw"])
    for i in range(4):
        np.testing.assert_allclose(stencil_band_matrix(wy[i], S).t().numpy(),
                                   s["mh"][i].numpy(), atol=1e-7)
        np.testing.assert_allclose(stencil_band_matrix(wx[i], S).numpy(),
                                   s["mw"][i].numpy(), atol=1e-7)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_crop", "split"])
def test_ssl_batch_augment_matches_jax(fused, interpret_mode):
    """`ssl_batch_augment` on values JAX sampled == `fused_ssl_batch_augment`
    with the same key, on a padded canvas with odd T."""
    p = jaug.AugmentParams(image_size=S, mxu_resample=fused)
    rng = np.random.RandomState(4)
    videos = rng.randint(0, 256, (2, 2, 3, H, W, 3)).astype(np.uint8)
    videos[:, :, :, 36:] = 0
    dims = np.array([[36.0, 44.0], [40.0, 40.0]], np.float32)
    key = jax.random.key(11)
    ref = jaug.fused_ssl_batch_augment(key, jnp.asarray(videos),
                                       jnp.asarray(dims), p)
    keys = jax.random.split(key, 4)
    fscal, orders, sigmas, boxes = [], [], [], []
    for i in range(4):
        k_crop, f, o, sg = jaug._sample_ssl_scalars(keys[i], p)
        boxes.append([float(b) for b in jaug.sample_rrc_box(k_crop, *dims[i // 2])])
        fscal.append(np.asarray(f))
        orders.append(np.asarray(o))
        sigmas.append(float(sg))
    sampled = {"fscal": torch.tensor(np.stack(fscal)),
               "orders": torch.tensor(np.stack(orders), dtype=torch.int32)}
    sampled.update(aug.ssl_matrices(torch.tensor(boxes), torch.tensor(sigmas),
                                    H, W, S))
    out = aug.ssl_batch_augment(torch.from_numpy(videos), sampled,
                                aug.AugmentParams(image_size=S, use_amp=fused))
    assert out.shape == (2, 2, 3, S, S, 3)
    ref = torch.from_numpy(np.array(ref))
    if fused:
        # under use_amp the port rounds its fp32 output to bf16: with that
        # output within ATOL of JAX's fp32 one, each value lies between the
        # bf16 roundings of JAX's value -/+ ATOL (rounding is monotone)
        assert out.dtype == torch.bfloat16
        lo, hi = (ref - ATOL).to(torch.bfloat16), (ref + ATOL).to(torch.bfloat16)
        assert bool(((out >= lo) & (out <= hi)).all())
    else:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


def test_sample_ssl_batch_is_reproducible_and_in_range():
    p = aug.AugmentParams(image_size=S)
    a = aug.sample_ssl_batch(torch.Generator().manual_seed(3), 2, 2, H, W,
                             [[36, 44], [40, 40]], p)
    b = aug.sample_ssl_batch(torch.Generator().manual_seed(3), 2, 2, H, W,
                             [[36, 44], [40, 40]], p)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    top, left, h, w = a["boxes"].unbind(1)
    true_h = torch.tensor([36.0, 36.0, 40.0, 40.0])
    true_w = torch.tensor([44.0, 44.0, 40.0, 40.0])
    assert bool(((top + h <= true_h) & (left + w <= true_w)).all())
    assert sorted(a["orders"][0].tolist()) == [0, 1, 2, 3]
    assert bool(((a["sigmas"] >= 0.1) & (a["sigmas"] < 2.0)).all())


# ---------------------------------------------------------------------------
# the crop kernel's plan (csrc/photometric.cu's crop_strip_kernel)
# ---------------------------------------------------------------------------

def _boxes(H, W, gen):
    """(top, left, height, width) boxes inside an H x W canvas: the whole
    canvas, a small one the crop upsamples, one reading most of the canvas,
    and a few RandomResizedCrop draws."""
    boxes = [(0, 0, H, W), (H // 3, W // 4, max(2, H // 16), max(2, W // 16)),
             (2, 1, H - 5, W - 3)]
    boxes += [tuple(float(b) for b in aug.sample_rrc_box(gen, H, W)) for _ in range(4)]
    return boxes


def _chunks(plan, S, halo):
    """Every range of output rows a block stages: a strip of one chunk its
    rows; a chunked strip each chunk, with the blur's halo (clipped to the
    frame) and without."""
    for y0 in range(0, S, plan.rows):
        y1 = min(S, y0 + plan.rows)
        for c0 in range(y0, y1, plan.chunk):
            c1 = min(y1, c0 + plan.chunk)
            yield c0, c1
            if plan.chunk < plan.rows:
                yield max(0, c0 - halo), min(S, c1 + halo)


def _band(idx, w, ra, rb):
    """Rows (or columns) [lo, hi + 1] the taps of outputs [ra, rb) read."""
    live = (w[ra:rb] != 0).any(-1)
    sel = idx[ra:rb][live]
    return int(sel.max()) + 2 - int(sel.min())


@pytest.mark.parametrize("S,H,W", [(9, 40, 36), (100, 256, 256), (224, 256, 256),
                                   (224, 512, 512), (512, 512, 512), (224, 1024, 768)])
def test_crop_plan_holds_every_band(S, H, W):
    """The plan covers the frame with CROP_STRIPS strips, fits the H100's
    shared memory, and its band holds the canvas rows and columns that any
    staged range of output rows reads, for boxes that upsample, that read
    (nearly) the whole canvas and that RandomResizedCrop draws."""
    plan = ph.crop_plan(S, H, W)
    assert plan.rows * ph.CROP_STRIPS >= S and 1 <= plan.chunk <= plan.rows
    assert 1 <= plan.vrows <= min(plan.chunk, ph.CROP_VROWS)
    assert plan.smem == ph.crop_smem(S, ph.pre_rows(S, plan.rows, plan.chunk),
                                     plan.band_rows, plan.band_cols,
                                     plan.vrows) <= ph.CROP_SMEM
    assert plan.band_cols % 16 == 0 and plan.band_cols >= W
    gen = torch.Generator().manual_seed(S)
    for top, left, h, w in _boxes(H, W, gen):
        ridx, rwt = ph.resample_taps(aug._rrc_matrix(H, S, h, top))
        cidx, cwt = ph.resample_taps(aug._rrc_matrix(W, S, w, left))
        assert _band(cidx, cwt, 0, S) <= plan.band_cols
        for ra, rb in _chunks(plan, S, ph.CROP_HALO):
            assert _band(ridx, rwt, ra, rb) <= plan.band_rows, (top, h, ra, rb)


def test_crop_plan_single_pass_at_the_training_shape():
    """At S 224 on a 256 or 512 canvas a strip is one chunk (the contrast mean
    from the values in shared memory, no second sweep), and on the 256 one
    three blocks fit an SM's 228 KB; S 512 is chunked."""
    plan = ph.crop_plan(224, 256, 256)
    assert plan[:2] == (14, 14) and 3 * plan.smem <= 228 * 1024
    assert ph.crop_plan(224, 512, 512)[:2] == (14, 14)
    plan = ph.crop_plan(512, 512, 512)
    assert plan.rows == 32 and plan.chunk < plan.rows


def _crop_args(S=32, H=40, W=44, T=1, dtype=torch.uint8):
    BV = 2
    videos = torch.zeros(BV, T, 3, H, W, dtype=dtype)
    rh, rw = torch.zeros(BV, S, H), torch.zeros(BV, W, S)
    fscal, orders = torch.zeros(BV, 8), torch.zeros(BV, 4, dtype=torch.int32)
    mh, mw = torch.zeros(BV, S, S), torch.zeros(BV, S, S)
    return videos, rh, rw, fscal, orders, mh, mw


CROP_REFUSALS = {  # case: (the arguments, what the refusal names)
    "S 8": (_crop_args(S=8), "output size 8"),
    "S 513": (_crop_args(S=513, H=4, W=4), "output size 513"),
    "2048 canvas": (_crop_args(S=224, H=2048, W=2048), "does not fit"),
    "fp32 frames": (_crop_args(dtype=torch.float32), "uint8"),
    "65536 frames": (_crop_args(H=2, W=2, T=65536), "65535"),
}


@pytest.mark.parametrize("case", list(CROP_REFUSALS))
def test_crop_kernel_refuses_before_any_launch(monkeypatch, case):
    """What crop_strip_kernel does not take (S outside 9..512, a canvas
    whose band does not fit shared memory even a row at a time, frames other
    than uint8, more frames a view than the grid's 65535) is refused before
    the library is built or launched: the device test is forced to say
    "kernel" on these CPU tensors, and reaching the library fails the
    test."""
    def no_library(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setattr(ph, "use_kernel", lambda *args: True)
    monkeypatch.setattr(ph, "_library", no_library)
    args, match = CROP_REFUSALS[case]
    before = ph.crop_photometric.launches
    with pytest.raises(ValueError, match=match):
        ph.crop_photometric(*args, out_dtype=torch.bfloat16)
    assert ph.crop_photometric.launches == before


def test_crop_kernel_takes_a_planned_canvas(monkeypatch):
    """The same forced route with a canvas the plan takes reaches the
    library."""
    def no_library(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setattr(ph, "use_kernel", lambda *args: True)
    monkeypatch.setattr(ph, "_library", no_library)
    with pytest.raises(AssertionError, match="reached the kernel"):
        ph.crop_photometric(*_crop_args(S=224, H=1024, W=768), out_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# the photometric-only kernel (#11) on the same strip design: its plan and
# its refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [9, 100, 222, 224, 480, 481, 512])
def test_photometric_plan_holds_every_strip(S):
    """The fp32 source's plan covers the frame with CROP_STRIPS strips, fits
    the H100's shared memory with no band and no taps, takes the largest
    chunk that fits, and every range of rows a block stages (a strip's, or a
    chunk's with the blur's halo clipped to the frame) fits the rows it
    holds."""
    plan = ph.photometric_plan(S)
    assert plan.rows == -(-S // ph.CROP_STRIPS) and plan.band_rows == plan.band_cols == 0
    assert 1 <= plan.chunk <= plan.rows
    assert 1 <= plan.vrows <= min(plan.chunk, ph.CROP_VROWS)
    pre = ph.pre_rows(S, plan.rows, plan.chunk)
    assert plan.smem == ph.crop_smem(S, pre, 0, 0, plan.vrows, taps=False) <= ph.CROP_SMEM
    if plan.chunk < plan.rows:
        bigger = plan.chunk + 1
        assert ph.crop_smem(S, ph.pre_rows(S, plan.rows, bigger), 0, 0,
                            min(ph.CROP_VROWS, bigger), taps=False) > ph.CROP_SMEM
    for ra, rb in _chunks(plan, S, ph.CROP_HALO):
        assert 0 <= ra < rb <= S and rb - ra <= pre, (ra, rb, pre)
    owned = [y for y0 in range(0, S, plan.rows)
             for c0 in range(y0, min(S, y0 + plan.rows), plan.chunk)
             for y in range(c0, min(S, y0 + plan.rows, c0 + plan.chunk))]
    assert owned == list(range(S))


def test_photometric_plan_at_the_training_shape():
    """At S 224 a strip is one 14-row chunk and three blocks fit an SM's 228
    KB (the crop kernel's occupancy); at S 512 strips are chunked."""
    plan = ph.photometric_plan(224)
    assert plan[:2] == (14, 14) and 3 * (plan.smem + 1024) <= 228 * 1024
    plan = ph.photometric_plan(512)
    assert plan.rows == 32 and plan.chunk < plan.rows


def _tail_args(S=32, T=1, dtype=torch.float32, shape=None):
    BV = 2
    videos = torch.zeros(shape or (BV, T, 3, S, S), dtype=dtype)
    fscal, orders = torch.zeros(BV, 8), torch.zeros(BV, 4, dtype=torch.int32)
    mh, mw = torch.zeros(BV, S, S), torch.zeros(BV, S, S)
    return videos, fscal, orders, mh, mw


def _with_grad(i):
    args = list(_tail_args())
    args[i] = args[i].requires_grad_()
    return tuple(args)


TAIL_REFUSALS = {  # case: (the arguments, the error, what it names)
    "S 8": (_tail_args(S=8), ValueError, "output size 8"),
    "S 513": (_tail_args(S=513), ValueError, "output size 513"),
    "uint8 frames": (_tail_args(dtype=torch.uint8), ValueError, "fp32"),
    "not square": (_tail_args(shape=(2, 1, 3, 32, 40)), ValueError, r"\(BV, T, 3, S, S\)"),
    "65536 frames": ((torch.zeros(1, 1, 1, 1, 1).expand(2, 65536, 3, 32, 32),)
                     + _tail_args()[1:], ValueError, "65535"),
    "videos require grad": (_with_grad(0), RuntimeError, "records no gradient"),
    "fscal requires grad": (_with_grad(1), RuntimeError, "records no gradient"),
    "mh requires grad": (_with_grad(3), RuntimeError, "records no gradient"),
    "mw requires grad": (_with_grad(4), RuntimeError, "records no gradient"),
}


def _as_if_cuda(monkeypatch):
    """`use_kernel` as it answers for a CUDA tensor (its grad check, then
    "kernel"), and a library that fails the test if reached."""
    from video_rep_learning_tpu_torch.ops.plain_grad import refuse_grad

    def no_library(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    def cuda_answer(name, x, *inputs):
        refuse_grad(name, x, *inputs)
        return True

    monkeypatch.setattr(ph, "use_kernel", cuda_answer)
    monkeypatch.setattr(ph, "_library", no_library)


@pytest.mark.parametrize("case", list(TAIL_REFUSALS))
def test_photometric_kernel_refuses_before_any_launch(monkeypatch, case):
    """What photometric_strip_kernel does not take (S outside 9..512, frames
    other than fp32 (BV, T, 3, S, S), more frames a view than the grid's
    65535) and a launch that would drop a gradient (the frames, the flags or
    the blur matrices require grad with grad mode on) are refused before the
    library is built or launched."""
    _as_if_cuda(monkeypatch)
    args, error, match = TAIL_REFUSALS[case]
    before = ph.photometric.launches
    with pytest.raises(error, match=match):
        ph.photometric(*args, out_dtype=torch.float32)
    assert ph.photometric.launches == before


@pytest.mark.parametrize("S", [9, 224, 512])
def test_photometric_kernel_takes_planned_frames(monkeypatch, S):
    """The same forced route reaches the library with frames it takes, with
    grad mode off for inputs that require grad."""
    _as_if_cuda(monkeypatch)
    args = _tail_args(S=S)
    args[0].requires_grad_()
    with torch.no_grad(), pytest.raises(AssertionError, match="reached the kernel"):
        ph.photometric(*args, out_dtype=torch.bfloat16)
