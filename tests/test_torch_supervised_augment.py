"""The port's supervised (non-SSL) augmentation against the JAX package's
`supervised_augment` on the same sampled values: each `adjust_*` and
`hflip` alone, then the whole recipe (the values the JAX recipe draws from
its key, fed to `supervised_batch_augment`) with every jitter, with the
configs' subset, without the random crop, and for a clip padded inside its
canvas; and the port's own sampler's values through the JAX package's ops
in the recipe's order. Randomness does not cross: the values do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_rep_learning_tpu.config import get_cfg as jax_get_cfg
from video_rep_learning_tpu.ops import augment as jaug
from video_rep_learning_tpu_torch.config import get_cfg
from video_rep_learning_tpu_torch.ops import augment as aug

torch.set_num_threads(1)

# fp32 elementwise ops in the same order: equal but for the contrast mean's
# and the resample's sums, taken in another order (values in [0, 1], or
# normalised to ~[-2, 2.7])
OP_ATOL, RECIPE_ATOL = 1e-6, 1e-5
T, H, W, S = 3, 24, 30, 16


def _video(seed, shape=(T, H, W, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _planar(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("op,factor", [("brightness", 1.3), ("brightness", 0.6),
                                       ("contrast", 1.4), ("contrast", 0.5),
                                       ("saturation", 1.5), ("saturation", 0.4),
                                       ("hue", 0.15), ("hue", -0.2)])
def test_adjust_op_matches_jax(op, factor):
    x = _video(0)
    ref = getattr(jaug, f"adjust_{op}")(jnp.asarray(x), factor)
    got = getattr(aug, f"adjust_{op}")(_planar(x), torch.full((1, 1, 1, 1), factor))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=OP_ATOL)


def test_adjust_contrast_over_the_true_extent_matches_jax():
    x = _video(1)
    ref = jaug.adjust_contrast(jnp.asarray(x), 1.6, dims=(17.0, 22.0))
    extent = torch.zeros(H, W)
    extent[:17, :22] = 1
    got = aug.adjust_contrast(_planar(x), torch.full((1, 1, 1, 1), 1.6), extent)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=OP_ATOL)


def test_hflip_matches_jax():
    x = _video(2)
    np.testing.assert_array_equal(_nhwc(aug.hflip(_planar(x))),
                                  np.asarray(jaug.hflip(jnp.asarray(x))))


def _aug_cfg(get, case):
    cfg = get()
    a = cfg.AUGMENTATION
    cfg.IMAGE_SIZE = S
    if case == "configs":  # the supervised configs' AUGMENTATION block
        a.BRIGHTNESS_MAX_DELTA, a.CONTRAST_MAX_DELTA = 32 / 255, 0.5
        a.HUE, a.SATURATION, a.RANDOM_CROP = False, False, False
    elif case == "no_crop":
        a.RANDOM_CROP = False
    return cfg


def _jax_values(key, a, dims):
    """The values `supervised_augment(key, ...)` draws, by its own key
    splits and samplers: factors [b, c, h, s], the box, the flip."""
    kb, kc, kh, ks, k_crop, k_flip = jax.random.split(key, 6)
    u = lambda k, d: float(jax.random.uniform(k, (), minval=-d, maxval=d))  # noqa: E731
    factors = [1.0 + u(kb, a.BRIGHTNESS_MAX_DELTA), 1.0 + u(kc, a.CONTRAST_MAX_DELTA),
               u(kh, a.HUE_MAX_DELTA), 1.0 + u(ks, a.SATURATION_MAX_DELTA)]
    if a.RANDOM_CROP:
        box = [float(v) for v in jaug.sample_rrc_box(k_crop, dims[0], dims[1])]
    else:
        box = [0.0, 0.0, float(dims[0]), float(dims[1])]
    flip = bool(jax.random.uniform(k_flip, ()) < 0.5) and a.RANDOM_FLIP
    return factors, box, flip


def _sampled(values, dims):
    """`sample_supervised_batch`'s dict for given per-clip values."""
    ry, rx = [], []
    for _, box, _ in values:
        wy, wx = aug.crop_matrices(H, W, *box, S)
        ry.append(wy.t())
        rx.append(wx)
    return {"factors": torch.tensor([v[0] for v in values]),
            "boxes": torch.tensor([v[1] for v in values]),
            "flips": torch.tensor([v[2] for v in values]),
            "dims": torch.tensor(dims, dtype=torch.float32),
            "ry": torch.stack(ry).contiguous(), "rx": torch.stack(rx)}


@pytest.mark.parametrize("case", ["all", "configs", "no_crop", "padded"])
def test_supervised_recipe_matches_jax(case):
    jcfg = _aug_cfg(jax_get_cfg, case)
    a = jcfg.AUGMENTATION
    frames = (np.random.RandomState(3).rand(2, T, H, W, 3) * 255).astype(np.uint8)
    dims = [[H, W], [H, W]]
    if case == "padded":  # the second clip fills 18 x 21 of its canvas
        frames[1, :, 18:] = 0
        frames[1, :, :, 21:] = 0
        dims[1] = [18, 21]
    refs, values = [], []
    for b in range(2):
        # key 1 draws a flip, key 2 none
        key = jax.random.key(b + 1)
        values.append(_jax_values(key, a, dims[b]))
        refs.append(np.asarray(jaug.supervised_augment(
            key, jnp.asarray(frames[b], jnp.float32) / 255.0, a, S,
            dims=(jnp.float32(dims[b][0]), jnp.float32(dims[b][1])))))
    params = aug.SupervisedParams.from_cfg(_aug_cfg(get_cfg, case))
    assert [v[2] for v in values] == [a.RANDOM_FLIP, False]
    got = aug.supervised_batch_augment(torch.from_numpy(frames),
                                       _sampled(values, dims), params)
    assert got.shape == (2, T, S, S, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.stack(refs), atol=RECIPE_ATOL)


def test_port_sampler_values_through_the_jax_ops():
    """`sample_supervised_batch`'s draws (factors in range, boxes inside each
    clip's true extent) applied by the JAX package's ops in the recipe's
    order equal `supervised_batch_augment` on them."""
    cfg = _aug_cfg(get_cfg, "all")
    params = aug.SupervisedParams.from_cfg(cfg)
    frames = (np.random.RandomState(4).rand(3, T, H, W, 3) * 255).astype(np.uint8)
    dims = np.array([[H, W], [20, 26], [H, 17]], np.float32)
    sampled = aug.sample_supervised_batch(torch.Generator().manual_seed(0), 3, H, W,
                                          dims, params)
    got = aug.supervised_batch_augment(torch.from_numpy(frames), sampled, params)
    f, boxes = sampled["factors"].numpy(), sampled["boxes"].numpy()
    assert np.all(np.abs(f[:, [0, 1, 3]] - 1) <= 0.8) and np.all(np.abs(f[:, 2]) <= 0.2)
    assert np.all(boxes[:, 0] + boxes[:, 2] <= dims[:, 0])
    assert np.all(boxes[:, 1] + boxes[:, 3] <= dims[:, 1])
    for b in range(3):
        v = jnp.asarray(frames[b], jnp.float32) / 255.0
        v = jaug.adjust_brightness(v, f[b, 0])
        v = jaug.adjust_contrast(v, f[b, 1], dims=tuple(dims[b]))
        v = jaug.adjust_hue(v, f[b, 2])
        v = jaug.adjust_saturation(v, f[b, 3])
        v = jaug.crop_resize(v, *(jnp.float32(x) for x in boxes[b]), S)
        if bool(sampled["flips"][b]):
            v = jaug.hflip(v)
        ref = jaug.color_normalization(jaug.resize_bilinear(v, S))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=RECIPE_ATOL)
