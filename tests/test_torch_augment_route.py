"""The route of the port's SSL augmentation (`ops/augment.py::crop_route`):
the crop kernel where its plan fits the canvas, else the split route (a
matmul resample a view and a chunk of frames at a time, then the
photometric-only kernel), and VRL_FUSED_CROP read as the JAX package's gate
(`fused_ssl_batch_augment`) reads it; the split route under USE_AMP against
the JAX package's split route on the same sampled values."""

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

# the augment parity test's tolerance (`test_torch_photometric.py`, from the
# JAX test of these kernels): fp32 on both sides, sums in another order
ATOL = 3e-5


@pytest.fixture
def interpret_mode():
    if jax.default_backend() != "tpu":
        with pltpu.force_tpu_interpret_mode():
            yield
    else:
        yield


def _one_step(H, W, S, use_amp, T=1, seed=0):
    """One clip of two views on an H x W canvas through `ssl_batch_augment`
    with sampled values; returns the output and the route counters' steps."""
    p = aug.AugmentParams(image_size=S, use_amp=use_amp)
    sampled = aug.sample_ssl_batch(torch.Generator().manual_seed(seed), 1, 2, H, W,
                                   None, p)
    videos = torch.randint(0, 256, (1, 2, T, H, W, 3),
                           generator=torch.Generator().manual_seed(seed + 1),
                           dtype=torch.uint8)
    before = (aug.ssl_batch_augment.crop_route, aug.ssl_batch_augment.split_route)
    out = aug.ssl_batch_augment(videos, sampled, p)
    after = (aug.ssl_batch_augment.crop_route, aug.ssl_batch_augment.split_route)
    return out, (after[0] - before[0], after[1] - before[1])


@pytest.mark.parametrize("canvas,route", [((1080, 1920), "split"), ((720, 1280), "crop")],
                         ids=["1080p", "720p"])
def test_use_amp_route_follows_the_plan(monkeypatch, canvas, route):
    """Under USE_AMP (VRL_FUSED_CROP unset) a 1080 x 1920 canvas at S 224,
    which the crop kernel's plan refuses, takes the split route and gives
    bf16 frames; a 720 x 1280 one takes the crop kernel. The route counters
    say which ran, and the plan was asked for this canvas."""
    monkeypatch.delenv("VRL_FUSED_CROP", raising=False)
    asked = []

    def plan(S, H, W):
        asked.append((S, H, W))
        return ph.fitting_plan(S, H, W)

    monkeypatch.setattr(aug, "fitting_plan", plan)
    H, W = canvas
    out, steps = _one_step(H, W, 224, use_amp=True)
    assert asked == [(224, H, W)]
    assert (ph.fitting_plan(224, H, W) is None) == (route == "split")
    assert steps == ((1, 0) if route == "crop" else (0, 1))
    assert out.shape == (1, 2, 1, 224, 224, 3) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())


def _jax_route(monkeypatch, use_amp):
    """The route the JAX package's `fused_ssl_batch_augment` takes under the
    current VRL_FUSED_CROP: its two kernels stubbed, one tiny call."""
    taken = []

    def crop(planar, *args, **kwargs):
        taken.append("crop")
        return jnp.zeros(planar.shape[:3] + (16, 16), jnp.float32)

    def split(cropped, *args, **kwargs):
        taken.append("split")
        return jnp.zeros_like(cropped, jnp.float32)

    monkeypatch.setattr(jpal, "fused_crop_photometric", crop)
    monkeypatch.setattr(jpal, "fused_photometric", split)
    p = jaug.AugmentParams(image_size=16, mxu_resample=use_amp, bf16_output=use_amp)
    videos = jnp.zeros((1, 2, 1, 20, 20, 3), jnp.uint8)
    jaug.fused_ssl_batch_augment(jax.random.key(0), videos, None, p)
    return taken


@pytest.mark.parametrize("use_amp", [True, False], ids=["amp", "fp32"])
@pytest.mark.parametrize("env", ["0", "1", "auto", None])
def test_fused_crop_gate_matches_jax(monkeypatch, env, use_amp):
    """VRL_FUSED_CROP picks the route the JAX package's gate picks on a
    canvas the plan takes: 0 split, 1 crop, auto (or unset) crop under
    USE_AMP, split without; on a canvas the plan refuses auto goes split and
    1 stays on the crop kernel."""
    if env is None:
        monkeypatch.delenv("VRL_FUSED_CROP", raising=False)
    else:
        monkeypatch.setenv("VRL_FUSED_CROP", env)
    assert _jax_route(monkeypatch, use_amp) == [aug.crop_route(16, 20, 20, use_amp)]
    assert aug.crop_route(224, 720, 1280, use_amp) == aug.crop_route(16, 20, 20, use_amp)
    want_1080 = {"0": "split", "1": "crop"}.get(env, "split")
    assert aug.crop_route(224, 1080, 1920, use_amp) == want_1080


def test_forced_crop_on_a_refused_canvas_raises(monkeypatch):
    """VRL_FUSED_CROP=1 keeps the crop kernel on a canvas its plan refuses,
    which raises before any launch (the kernel's own refusal, nothing
    caught): the device test is forced to say "kernel" on these CPU tensors,
    and reaching the library fails the test."""
    def no_library(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    monkeypatch.setenv("VRL_FUSED_CROP", "1")
    monkeypatch.setattr(ph, "use_kernel", lambda *args: True)
    monkeypatch.setattr(ph, "_library", no_library)
    before = (aug.ssl_batch_augment.crop_route, aug.ssl_batch_augment.split_route)
    with pytest.raises(ValueError, match="does not fit"):
        _one_step(2048, 2048, 224, use_amp=True)
    assert (aug.ssl_batch_augment.crop_route,
            aug.ssl_batch_augment.split_route) == before


def test_split_route_in_chunks_equals_one_chunk(monkeypatch):
    """The split route's resample a frame at a time gives the same frames
    as one chunk holding the whole view."""
    monkeypatch.setenv("VRL_FUSED_CROP", "0")
    one, _ = _one_step(40, 44, 32, use_amp=True, T=5)
    monkeypatch.setattr(aug, "SPLIT_CHUNK_BYTES", 12 * 40 * 44)
    chunked, steps = _one_step(40, 44, 32, use_amp=True, T=5)
    assert steps == (0, 1)
    assert torch.equal(one, chunked)


def test_split_route_under_amp_matches_jax(monkeypatch, interpret_mode):
    """Under USE_AMP with VRL_FUSED_CROP=0 the port's split route, fed the
    values JAX sampled, against JAX's split route (`fused_ssl_batch_augment`
    with the same key and gate) in fp32: each bf16 output lies between the
    bf16 roundings of JAX's value -/+ ATOL."""
    monkeypatch.setenv("VRL_FUSED_CROP", "0")
    monkeypatch.setattr(aug, "SPLIT_CHUNK_BYTES", 2 * 12 * 40 * 44)  # 2 frames a chunk
    S, H, W = 32, 40, 44
    p = jaug.AugmentParams(image_size=S, mxu_resample=True)
    rng = np.random.RandomState(5)
    videos = rng.randint(0, 256, (2, 2, 3, H, W, 3)).astype(np.uint8)
    videos[:, :, :, 36:] = 0
    dims = np.array([[36.0, 44.0], [40.0, 40.0]], np.float32)
    key = jax.random.key(12)
    ref = jaug.fused_ssl_batch_augment(key, jnp.asarray(videos), jnp.asarray(dims), p)
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
    sampled.update(aug.ssl_matrices(torch.tensor(boxes), torch.tensor(sigmas), H, W, S))
    before = aug.ssl_batch_augment.split_route
    out = aug.ssl_batch_augment(torch.from_numpy(videos), sampled,
                                aug.AugmentParams(image_size=S, use_amp=True))
    assert aug.ssl_batch_augment.split_route == before + 1
    assert out.shape == (2, 2, 3, S, S, 3) and out.dtype == torch.bfloat16
    ref = torch.from_numpy(np.array(ref))
    lo, hi = (ref - ATOL).to(torch.bfloat16), (ref + ATOL).to(torch.bfloat16)
    assert bool(((out >= lo) & (out <= hi)).all())
