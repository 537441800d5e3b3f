"""The whole CARL forward of the port against the JAX model at a small size:
full ResNet-50 depth, 32 px frames, a 2-layer temporal head. The JAX model is
built and initialised (all heads), its BN statistics are perturbed so BN does
real work, it is exported with `convert_to_carl_state_dict`, and the port
loads that strictly. Also the port's own invariants: `backbone_flat` +
`head_embs` == `forward`, and a padded, masked chunk == the exact-length
one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu.config import get_cfg
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models.import_torch import convert_to_carl_state_dict
from video_rep_learning_tpu_torch.models import build_model, state_dict_from_numpy

torch.set_num_threads(1)

# fp32 on both sides, but ResNet-50's 53 convolutions accumulate in another
# order in XLA and in oneDNN; features of order 1-10 differ by ~1e-5
ATOL = 1e-4
T, S = 12, 32


def small_carl_cfg():
    cfg = get_cfg()
    cfg.IMAGE_SIZE = S
    cfg.TRAIN.NUM_FRAMES = T
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 5  # chunks of 5, 5, 2 frames
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS = 2
    e.FC_LAYERS = [[32, True], [32, True]]
    e.CAPACITY_SCALAR = 1
    e.HIDDEN_SIZE = 64
    e.NUM_HEADS = 2
    e.D_FF = 64
    e.EMBEDDING_SIZE = 16
    cfg.MODEL.PROJECTION_SIZE = 24
    return cfg


def perturb_batch_stats(batch_stats, seed):
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(batch_stats)
    return traverse_util.unflatten_dict({
        k: (0.1 * rng.randn(*v.shape) if k[-1] == "mean"
            else 0.5 + rng.rand(*v.shape)).astype(np.float32)
        for k, v in flat.items()})


def init_jax_carl(cfg, x, seed=0):
    """JAX CARLModel variables with every head (projection, classifier)
    materialised and perturbed BN statistics."""
    model = jax_build_model(cfg)
    n = x.shape[1]

    def init_all(mdl, x, masks):
        mdl(x, n, video_masks=masks, project=True)
        return mdl(x, n, video_masks=masks, classification=True)

    variables = jax.jit(lambda r, a, m: model.init(r, a, m, method=init_all))(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        jnp.asarray(x), jnp.ones((x.shape[0], 1, n), jnp.float32))
    return model, {"params": variables["params"],
                   "batch_stats": perturb_batch_stats(
                       variables["batch_stats"], seed + 2)}


@pytest.fixture(scope="module")
def carl():
    cfg = small_carl_cfg()
    x = np.random.RandomState(0).rand(1, T, S, S, 3).astype(np.float32)
    jmodel, variables = init_jax_carl(cfg, x)
    sd = convert_to_carl_state_dict(variables["params"],
                                    variables["batch_stats"], layer=3)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_numpy(sd), strict=True)
    return cfg, jmodel, variables, model, x


def _mask(n_valid):
    m = np.zeros((1, 1, T), np.float32)
    m[..., :n_valid] = 1
    return m


@pytest.mark.parametrize("mode", ["embed", "project", "classify", "padded"])
def test_carl_forward_matches_jax(carl, mode):
    _, jmodel, variables, model, x = carl
    n = 9 if mode == "padded" else T
    kw = dict(project=mode == "project", classification=mode == "classify")
    apply = jax.jit(lambda v, a, m: jmodel.apply(
        v, a, T, video_masks=m, train=False, true_seq_len=jnp.int32(n), **kw))
    ref = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(_mask(n))))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), T, video_masks=torch.from_numpy(_mask(n)),
                    true_seq_len=n, **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[:, :n], ref[:, :n], atol=ATOL)


def test_backbone_flat_features_match_jax(carl):
    _, jmodel, variables, model, x = carl
    ref, cls = jax.jit(lambda v, a: jmodel.apply(v, a, method="backbone_flat"))(
        variables, jnp.asarray(x[0]))
    with torch.inference_mode():
        feats, tcls = model.backbone_flat(torch.from_numpy(x[0]))
    assert cls is None and tcls is None
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1.0  # BN perturbation keeps features alive
    np.testing.assert_allclose(feats.permute(0, 2, 3, 1).numpy(), ref,
                               atol=ATOL)


def test_flat_split_matches_full_forward(carl):
    """`backbone_flat` + `head_embs` reproduce `forward`, the seam a
    frame-packed extraction rests on."""
    _, _, _, model, x = carl
    xt = torch.from_numpy(x)
    masks = torch.ones(1, 1, T)
    with torch.inference_mode():
        full = model(xt, T, video_masks=masks, true_seq_len=T)
        feats, cls = model.backbone_flat(xt[0])
        flat = model.head_embs(feats[None], cls, video_masks=masks,
                               true_seq_len=T)
    np.testing.assert_allclose(full.numpy(), flat.numpy(), atol=2e-6)


def test_padded_chunk_matches_exact_length(carl):
    """Padding a chunk with copies of its last frame, masking the pad keys
    and taking positions from the true length reproduces the exact-length
    forward on the valid frames."""
    _, _, _, model, x = carl
    n = 9
    exact_in = torch.from_numpy(x[:, :n])
    padded_in = torch.cat([exact_in, exact_in[:, -1:].expand(1, T - n, S, S, 3)],
                          dim=1)
    with torch.inference_mode():
        exact = model(exact_in, n, true_seq_len=n)
        padded = model(padded_in, T, video_masks=torch.from_numpy(_mask(n)),
                       true_seq_len=n)
    np.testing.assert_allclose(padded[:, :n].numpy(), exact.numpy(), atol=2e-5)
