"""The port's frame-packed and packed eval sweeps against its per-video
sweep, and against the JAX package's frame-packed sweep.

- CARL (full ResNet-50 depth at 32 px, a 2-layer encoder) and a tiny
  MV-Former (smart fusion over a 128-d test ViT): the flat sweep at the
  default block and at FB blocks that split videos and leave a short last
  block, and the packed sweep at P 2 and 3 over uneven lengths (several
  chunks a video at FRAMES_PER_BATCH 8), each within atol 2e-6 of the
  per-video sweep, the JAX package's own tolerance for its sweeps
  (`tests/test_eval.py`): fp32 on both, the same per-frame math on blocks
  of another size, and masked keys that add zeros, so only the order of
  sums differs.
- The flat sweep against JAX `_iter_frameflat` on the same weights (the
  JAX init exported with `convert_to_carl_state_dict` /
  `convert_to_mvf_state_dict`) at `tests/test_torch_evaluate.py`'s EMB_ATOL
  1e-4.
- The dispatch against JAX `iter_video_embeddings` (its sweeps stubbed):
  VRL_EVAL_FLAT 0 / 1 / auto with EVAL.FLAT_EXTRACT, EVAL.PACK_VIDEOS, and
  NUM_CONTEXTS 2 or the conv embedder falling to the per-video sweep.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.evaluation import embedding as jax_emb
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.models.import_torch import (convert_to_carl_state_dict,
                                                        convert_to_mvf_state_dict)
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch.evaluation import embedding
from video_rep_learning_tpu_torch.models import build_model, state_dict_from_numpy
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import load_model_state

from tests.test_torch_model import perturb_batch_stats

torch.set_num_threads(1)

S, T, RAW = 32, 8, 40
SWEEP_ATOL = 2e-6  # tests/test_eval.py's, the JAX package's own sweeps
EMB_ATOL = 1e-4    # tests/test_torch_evaluate.py's, port against JAX
LENS = (7, 13, 5, 20, 11)  # 56 frames, 1-3 chunks a video at FRAMES_PER_BATCH 8
TEST_VIT = "vit_test_128"

HEAD = ["MODEL.EMBEDDER_MODEL.NUM_LAYERS", "2",
        "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
        "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1",
        "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
        "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
        "MODEL.EMBEDDER_MODEL.D_FF", "48",
        "MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE", "16",
        "MODEL.PROJECTION_SIZE", "24"]
FAMILIES = {
    "carl": ["IMAGE_SIZE", str(S), "TRAIN.NUM_FRAMES", str(T),
             "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "16", "EVAL.FRAMES_PER_BATCH", "8",
             *HEAD],
    # configs_mvf/pouring_mvf.yml's head (smart fusion, 3 LSTP tokens,
    # SMART_FINAL one, one-hot positions in the pool) on the test ViT
    "mvf": ["MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}", "MODEL.BASE_MODEL.LAYER", "12",
            "MODEL.EMBEDDER_MODEL.FUSION_TYPE", "smart",
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,1",
            "MODEL.EMBEDDER_MODEL.SMART_FINAL", "one",
            "MODEL.EMBEDDER_MODEL.SMART_ONE_HOT", "pool",
            "MODEL.EMBEDDER_MODEL.SMART_TOKENS", "3",
            "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
            "IMAGE_SIZE", str(S), "TRAIN.NUM_FRAMES", str(T),
            "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "16", "EVAL.FRAMES_PER_BATCH", "8",
            *HEAD],
}


def make_cfg(config_module, family, extra=()):
    cfg = config_module.get_cfg()
    config_module.apply_opts(cfg, [*FAMILIES[family], "USE_AMP", "False", *extra])
    return cfg


def make_items(lens=LENS, seed=0):
    """Eval items as `EvalLoader` gives them: uint8 videos of RAW x RAW
    (dims smaller on one video: a padded canvas), labels with some < 0."""
    rng = np.random.RandomState(seed)
    items = []
    for i, n in enumerate(lens):
        labels = rng.randint(-1, 4, n)
        items.append({"video": rng.randint(0, 256, (n, RAW, RAW, 3)).astype(np.uint8),
                      "labels": labels, "seq_len": n,
                      "dims": np.array([RAW - 6 * (i == 1), RAW], np.float32),
                      "chosen_steps": np.arange(n), "name": f"v{i}"})
    return items


@pytest.fixture(scope="module")
def test_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_SPECS, TEST_VIT, jax_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT, port_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        yield


_MODELS = {}


@pytest.fixture(params=list(FAMILIES))
def family(request, test_vit):
    """(family, JAX model, its variables, the port's model on them), built
    once a module: the JAX init with perturbed BN statistics, exported."""
    name = request.param
    if name not in _MODELS:
        cfg = make_cfg(jax_config, name)
        jmodel = jax_build_model(cfg)
        x = np.random.RandomState(4).rand(1, T, S, S, 3).astype(np.float32)

        def init_all(mdl, x, masks):
            return mdl(x, T, video_masks=masks, project=True)

        variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
            {"params": jax.random.key(5), "dropout": jax.random.key(6)},
            jnp.asarray(x), jnp.ones((1, 1, T), jnp.float32))
        stats = perturb_batch_stats(variables["batch_stats"], 7)
        variables = {"params": variables["params"], "batch_stats": stats}
        if name == "mvf":
            sd = convert_to_mvf_state_dict(variables["params"], stats, depth=2,
                                           patch_size=8)
        else:
            sd = convert_to_carl_state_dict(variables["params"], stats, layer=3)
        model = build_model(make_cfg(port_config, name))
        load_model_state(model, state_dict_from_numpy(sd))
        _MODELS[name] = (name, jmodel, variables, model)
    return _MODELS[name]


def sweep(cfg, model, items, monkeypatch, flat=None):
    """The port's records of `items` through `iter_video_embeddings`, with
    VRL_EVAL_FLAT set to `flat` (None: unset)."""
    if flat is None:
        monkeypatch.delenv("VRL_EVAL_FLAT", raising=False)
    else:
        monkeypatch.setenv("VRL_EVAL_FLAT", flat)
    return list(embedding.iter_video_embeddings(cfg, model, items, "cpu"))


def assert_same_records(got, want, atol):
    assert [r["name"] for r in got] == [r["name"] for r in want]  # loader order
    for g, w in zip(got, want):
        assert g["embs"].shape == w["embs"].shape and g["embs"].dtype == np.float32
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert (g["seq_len"], g["input_len"]) == (w["seq_len"], w["input_len"])
        np.testing.assert_allclose(g["embs"], w["embs"], atol=atol, rtol=0,
                                   err_msg=g["name"])


_PER_VIDEO = {}


def per_video(name, model, monkeypatch):
    if name not in _PER_VIDEO:
        cfg = make_cfg(port_config, name)
        assert embedding.eval_sweep(cfg, model) == "per_video"
        _PER_VIDEO[name] = sweep(cfg, model, make_items(), monkeypatch)
    return _PER_VIDEO[name]


@pytest.mark.parametrize("block", [0, 6, 16])
def test_flat_sweep_matches_per_video(family, block, monkeypatch):
    """FB 0 (the default: min(FRAMES_PER_BATCH 8, 256 / 128) = 8), 6 and
    16: blocks that split videos and, with 56 frames, leave a short last
    block (2, 8); EVAL.FLAT_EXTRACT with VRL_EVAL_FLAT unset."""
    name, _, _, model = family
    want = per_video(name, model, monkeypatch)
    cfg = make_cfg(port_config, name, ["EVAL.FLAT_EXTRACT", "True",
                                       "EVAL.FLAT_BLOCK", str(block)])
    assert embedding.flat_block(cfg, model) == (block or 8)
    assert embedding.eval_sweep(cfg, model) == "flat"
    calls = []
    trunk = model.backbone_flat
    monkeypatch.setattr(model, "backbone_flat",
                        lambda x: calls.append(x.shape[0]) or trunk(x))
    got = sweep(cfg, model, make_items(), monkeypatch)
    fb = block or 8
    assert calls == [fb] * (sum(LENS) // fb) + ([sum(LENS) % fb] if sum(LENS) % fb else [])
    assert_same_records(got, want, SWEEP_ATOL)


@pytest.mark.parametrize("pack", [2, 3])
def test_packed_sweep_matches_per_video(family, pack, monkeypatch):
    """Windows of 2P videos, groups of up to P chunks of uneven length, each
    padded to its longest with a key mask and per-chunk true lengths."""
    name, _, _, model = family
    want = per_video(name, model, monkeypatch)
    cfg = make_cfg(port_config, name, ["EVAL.PACK_VIDEOS", str(pack)])
    assert embedding.eval_sweep(cfg, model) == "packed"
    shapes = []
    forward = model.forward

    def spy(x, *a, **kw):
        shapes.append((tuple(x.shape[:2]), kw["video_masks"].sum(dim=(1, 2)).tolist(),
                       kw["true_seq_len"].tolist()))
        return forward(x, *a, **kw)

    monkeypatch.setattr(model, "forward", spy)
    got = sweep(cfg, model, make_items(), monkeypatch)
    # the chunks of each window, longest first, in groups of up to P
    chunks = [[n for _, n in embedding._chunks(L, 8)] for L in LENS]
    expect = []
    for w in range(0, len(LENS), 2 * pack):
        lens = sorted((n for c in chunks[w:w + 2 * pack] for n in c), reverse=True)
        for g in range(0, len(lens), pack):
            grp = lens[g:g + pack]
            expect.append(((len(grp), grp[0]), [float(n) for n in grp], grp))
    assert shapes == expect
    assert any(len(set(lens)) > 1 for _, _, lens in shapes)  # some padding
    assert_same_records(got, want, SWEEP_ATOL)


def test_flat_sweep_matches_jax(family, monkeypatch):
    """The port's flat sweep against JAX `_iter_frameflat` (blocks of 6, its
    last block and head chunks zero-padded to buckets and masked) on the
    same weights."""
    name, jmodel, variables, model = family
    opts = ["EVAL.FLAT_EXTRACT", "True", "EVAL.FLAT_BLOCK", "6"]
    want = list(jax_emb._iter_frameflat(make_cfg(jax_config, name, opts), jmodel,
                                        variables, make_items()))
    got = sweep(make_cfg(port_config, name, opts), model, make_items(), monkeypatch)
    assert_same_records(got, want, EMB_ATOL)


DISPATCH = [  # (VRL_EVAL_FLAT, FLAT_EXTRACT, PACK_VIDEOS, NUM_CONTEXTS, embedder, sweep)
    (None, False, 1, 1, "transformer", "per_video"),
    (None, True, 1, 1, "transformer", "flat"),
    ("auto", True, 1, 1, "transformer", "flat"),
    ("auto", False, 3, 1, "transformer", "packed"),
    ("0", True, 1, 1, "transformer", "per_video"),
    ("0", True, 2, 1, "transformer", "packed"),
    ("1", False, 1, 1, "transformer", "flat"),
    ("1", False, 2, 1, "transformer", "flat"),
    ("1", True, 1, 2, "transformer", "per_video"),
    ("1", True, 2, 2, "transformer", "per_video"),
    ("1", True, 1, 1, "conv", "per_video"),
    ("1", True, 2, 1, "conv", "packed"),
    (None, False, 2, 2, "conv", "per_video"),
]


@pytest.mark.parametrize("env, flat, pack, contexts, embedder, want", DISPATCH)
def test_dispatch_matches_jax(env, flat, pack, contexts, embedder, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("VRL_EVAL_FLAT", raising=False)
    else:
        monkeypatch.setenv("VRL_EVAL_FLAT", env)
    opts = ["EVAL.FLAT_EXTRACT", str(flat), "EVAL.PACK_VIDEOS", str(pack),
            "DATA.NUM_CONTEXTS", str(contexts)]
    model = SimpleNamespace(spec=SimpleNamespace(embedder_type=embedder, vit_spec=None))

    def stub(tag):
        def gen(*args, **kwargs):
            yield tag
        return gen

    monkeypatch.setattr(jax_emb, "_iter_frameflat", stub("flat"))
    monkeypatch.setattr(jax_emb, "_iter_packed", stub("packed"))
    # the per-video sweep over no videos yields nothing
    jax_took = list(jax_emb.iter_video_embeddings(
        make_cfg(jax_config, "carl", opts), model, None, []))
    assert (jax_took[0] if jax_took else "per_video") == want
    assert embedding.eval_sweep(make_cfg(port_config, "carl", opts), model) == want


def test_bad_flat_switch_raises(monkeypatch):
    monkeypatch.setenv("VRL_EVAL_FLAT", "yes")
    model = SimpleNamespace(spec=SimpleNamespace(embedder_type="transformer",
                                                 vit_spec=None))
    with pytest.raises(ValueError, match="VRL_EVAL_FLAT"):
        embedding.eval_sweep(make_cfg(port_config, "carl"), model)
