"""The port's eval preprocessing against `video_rep_learning_tpu.ops.augment`,
which resamples with `jax.image.scale_and_translate`: canvases smaller and
larger than 224, non-square, a true extent inside a padded canvas, and the
dims-less crop path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_rep_learning_tpu.ops.augment import eval_augment as jax_eval_augment
from video_rep_learning_tpu_torch.ops.augment import eval_augment

torch.set_num_threads(1)

# fp32 on both sides with bit-identical resampling weights; what is left is
# the order of the two weight contractions, then /0.225 in the normalisation
ATOL = 1e-5


@pytest.mark.parametrize("canvas,dims", [
    ((40, 40), (40, 40)),
    ((256, 256), (256, 256)),
    ((240, 320), (240, 320)),
    ((256, 320), (200, 300)),   # true extent inside a padded canvas
    ((300, 200), (300, 200)),
    ((40, 40), None),
    ((240, 320), None),
], ids=str)
def test_eval_augment_matches_jax(canvas, dims):
    H, W = canvas
    frames = np.random.RandomState(H + W).randint(0, 256, (3, H, W, 3),
                                                  dtype=np.uint8)
    jdims = None if dims is None else tuple(jnp.float32(d) for d in dims)
    ref = jax_eval_augment(jnp.asarray(frames).astype(jnp.float32) / 255.0,
                           224, dims=jdims)
    out = eval_augment(torch.from_numpy(frames).float() / 255.0, 224, dims=dims)
    assert out.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
