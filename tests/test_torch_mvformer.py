"""The port's MV-Former against the JAX package on the same weights: LSTP
(static and dynamic queries with each DYNAMIC_CTRL, disjoint, L2-normalised
keys, VAL_PASS with bf16 tokens), the multi-entity embedder (each
SMART_ONE_HOT and SMART_FINAL, the fixed-width baseline, dynamic tokens),
and whole small MV-Former models exported with `convert_to_mvf_state_dict`
(ResNet ones with `convert_to_carl_state_dict`) and loaded strictly; then
`evaluate.main` on the CPU over the synthetic set with a shrunk
`configs_mvf/pouring_mvf.yml`.

The whole models use a test-only ViT spec (128-d, 2 blocks, 2 heads, patch 8
at 32 px, 17 tokens), added with `monkeypatch.setitem` to both packages'
`VIT_SPECS`.

Tolerances (max |port - JAX|): fp32 on both sides, the same math summed in
another order: 1e-5 for the heads (values of order 1), 5e-5 for whole
models (two ViT blocks, or ResNet-50's 53 convolutions, then the head;
unit-norm embeddings). The bf16 LSTP case: its pooled tokens are rounded to
bf16 on both sides from fp32 values that agree to ~1e-6, so one bf16 ulp of
the largest value (2^-7 of it).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models import mvformer as jax_mvf
from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.models.import_torch import (
    _inv_embed_head, convert_to_carl_state_dict, convert_to_mvf_state_dict)
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch.models import (build_model, load_checkpoint,
                                                 save_checkpoint,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.models import mvformer as port_mvf
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import load_model_state

from tests.test_torch_model import perturb_batch_stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MVF_CFG = os.path.join(REPO, "configs_mvf", "pouring_mvf.yml")
HEAD_ATOL, MODEL_ATOL = 1e-5, 5e-5
TEST_VIT = "vit_test_128"


def _lin(p):
    return {"weight": np.asarray(p["Dense_0"]["kernel"]).T,
            "bias": np.asarray(p["Dense_0"]["bias"])}


def _lstp_state(p):
    """JAX LSTPCrossAtt params -> the port's (reference) names."""
    sd = {}
    for name in ("linear_K2d", "linear_V2d", "in2dynQ"):
        if name in p:
            sd.update({f"{name}.{k}": v for k, v in _lin(p[name]).items()})
    for name in ("Q_s", "Q_s_b"):
        if name in p:
            sd[name] = np.asarray(p[name])
    return state_dict_from_numpy(sd)


LSTP_CASES = {
    "static": dict(num_static=3, num_dynamic=0),
    "dynamic_separate": dict(num_static=2, num_dynamic=2),
    "dynamic_first": dict(num_static=0, num_dynamic=2, dyn_ctrl="first"),
    "dynamic_average": dict(num_static=2, num_dynamic=1, dyn_ctrl="average"),
    "disjoint": dict(num_static=3, num_dynamic=1, disjoint=True),
    "ln_keys": dict(num_static=3, num_dynamic=0, ln_keys=True),
    "val_pass_bf16": dict(num_static=2, num_dynamic=1, val_pass=True,
                          dyn_ctrl="average"),
}


@pytest.mark.parametrize("case", list(LSTP_CASES))
def test_lstp_matches_jax(case):
    kw = LSTP_CASES[case]
    bf16 = case.endswith("bf16")
    rng = np.random.RandomState(0)
    Fr, S, C, C_dyn, T = 6, 16, 32, 24, 3
    d_model = C if kw.get("val_pass") else 20
    tokens = rng.randn(Fr, S, C).astype(np.float32)
    dyn = rng.randn(Fr, C_dyn).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jmod = jax_mvf.LSTPCrossAtt(d_model=d_model, d_dyn_in=C_dyn, **kw)
    jt, jd = jnp.asarray(tokens, jdt), jnp.asarray(dyn, jdt)
    params = jax.jit(lambda r, a, b: jmod.init(r, a, b, T))(
        jax.random.key(1), jt, jd)["params"]
    want, want_attn = jax.jit(lambda v, a, b: jmod.apply(v, a, b, T))(
        {"params": params}, jt, jd)

    port = port_mvf.LSTPCrossAtt(C, d_model=d_model, d_dyn_in=C_dyn, **kw)
    port.load_state_dict(_lstp_state(params), strict=True)
    tdt = torch.bfloat16 if bf16 else torch.float32
    with torch.inference_mode():
        got, attn = port(torch.from_numpy(tokens).to(tdt),
                         torch.from_numpy(dyn).to(tdt), T)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    # VAL_PASS pools the tokens themselves, in their type; else fp32 values
    assert got.dtype == (tdt if kw.get("val_pass") else torch.float32)
    tol = 2.0 ** -7 * np.abs(want).max() if bf16 else HEAD_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=HEAD_ATOL)


EMB_CASES = {
    "none_max": dict(one_hot_pos="none", smart_final="max"),
    "pool_one": dict(one_hot_pos="pool", smart_final="one"),
    "enc_avg": dict(one_hot_pos="enc", smart_final="avg"),
    "pool_lin": dict(one_hot_pos="pool", smart_final="lin"),
    "enc_lin_dynamic": dict(one_hot_pos="enc", smart_final="lin", num_dynamic=2,
                            dyn_ctrl="first"),
    "fixed_width_baseline": dict(one_hot_pos="none", smart_final="max",
                                 fixed_width_baseline=True),
}


@pytest.mark.parametrize("case", list(EMB_CASES))
def test_multi_entity_embedder_matches_jax(case):
    kw = dict(EMB_CASES[case])
    num_dynamic = kw.pop("num_dynamic", 0)
    BV, T, h, C, C_cls, n_valid = 2, 5, 3, 24, 16, 4
    common = dict(hidden_channels=32, embedding_size=16, fc_channels=(40,),
                  drop_rate=0.1, num_layers=2, num_heads=2, d_ff=48,
                  train_num_frames=8, num_static=2, num_dynamic=num_dynamic,
                  pool_channels=20, d_dyn_in=C_cls, **kw)
    rng = np.random.RandomState(1)
    x = rng.randn(BV, T, h, h, C).astype(np.float32)
    cls = rng.randn(BV * T, C_cls).astype(np.float32)
    masks = np.zeros((BV, 1, T), np.float32)
    masks[..., :n_valid] = 1
    jmod = jax_mvf.MultiEntityTransformerEmbModel(**common)
    args = (jnp.asarray(x), jnp.asarray(masks), jnp.asarray(cls))
    variables = jax.jit(jmod.init)(jax.random.key(2), *args)
    stats = perturb_batch_stats(variables["batch_stats"], 3)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, true_len=jnp.int32(n_valid)))(
        {"params": variables["params"], "batch_stats": stats}, *args)

    sd, consumed = {}, set()
    _inv_embed_head(sd, traverse_util.flatten_dict({"embed": variables["params"]}),
                    traverse_util.flatten_dict({"embed": stats}), consumed)
    if common.get("smart_final") == "lin":  # the exporter names it embed.lin_final
        assert "embed.lin_final.weight" in sd
    port = port_mvf.MultiEntityTransformerEmbModel(C, **common).eval()
    port.load_state_dict(state_dict_from_numpy(
        {k[len("embed."):]: v for k, v in sd.items()}), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(masks),
                   torch.from_numpy(cls), true_len=n_valid)
    np.testing.assert_allclose(got[:, :n_valid].numpy(),
                               np.asarray(want)[:, :n_valid], atol=HEAD_ATOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

T, S = 6, 32
MODEL_CASES = {
    # the flagship wiring of configs_mvf/pouring_mvf.yml on the test ViT
    "pouring_mvf": ("vit", ["MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,1"]),
    "vit_dynamic_cls_res": ("vit", [
        "MODEL.EMBEDDER_MODEL.SMART_DYNAMIC_TOKENS", "2",
        "MODEL.EMBEDDER_MODEL.DYNAMIC_CTRL", "average",
        "MODEL.EMBEDDER_MODEL.SMART_LN_KEYS", "True",
        "MODEL.EMBEDDER_MODEL.SMART_FINAL", "max", "MODEL.CLS_RES", "True"]),
    # configs_mvf/ablate_rn50_lstp3.yml's head over ResNet-50 (LAYER 3)
    "rn50_lstp3": ("resnet", ["MODEL.BASE_MODEL.NETWORK", "Resnet50_byol",
                              "MODEL.BASE_MODEL.LAYER", "3"]),
}


def small_mvf_cfg(config_module, extra=()):
    cfg = config_module.get_cfg()
    config_module.load_yaml_into(cfg, MVF_CFG)
    config_module.apply_opts(cfg, [
        "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}", "IMAGE_SIZE", str(S),
        "USE_AMP", "False", "TRAIN.NUM_FRAMES", str(T),
        "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "4",
        "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1",
        "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "2",
        "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
        "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1",
        "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
        "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
        "MODEL.EMBEDDER_MODEL.D_FF", "48",
        "MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE", "16",
        "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
        "MODEL.PROJECTION_SIZE", "24", *extra])
    return cfg


@pytest.fixture(scope="module")
def test_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_SPECS, TEST_VIT, jax_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT, port_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        yield


_MODELS = {}


@pytest.fixture
def mvf_model(test_vit, request):
    """(JAX model, its variables, the port's model loaded from them, input,
    backbone kind) for MODEL_CASES[request.param], built once a module."""
    case = request.param
    if case in _MODELS:
        return _MODELS[case]
    kind, extra = MODEL_CASES[case]
    cfg = small_mvf_cfg(jax_config, extra)
    jmodel = jax_build_model(cfg)
    x = np.random.RandomState(4).rand(1, T, S, S, 3).astype(np.float32)

    def init_all(mdl, x, masks):
        return mdl(x, T, video_masks=masks, project=True)

    variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)},
        jnp.asarray(x), jnp.ones((1, 1, T), jnp.float32))
    stats = perturb_batch_stats(variables["batch_stats"], 7)
    variables = {"params": variables["params"], "batch_stats": stats}
    if kind == "vit":
        sd = convert_to_mvf_state_dict(variables["params"], stats, depth=2,
                                       patch_size=8)
    else:
        sd = convert_to_carl_state_dict(variables["params"], stats, layer=3)
    model = build_model(small_mvf_cfg(port_config, extra))
    load_model_state(model, state_dict_from_numpy(sd))
    _MODELS[case] = (jmodel, variables, model, x, kind)
    return _MODELS[case]


# the flagship in every mode; the others where they differ from it (the
# ResNet model's trunk is the CARL one, held in tests/test_torch_model.py)
MODEL_MODES = [("pouring_mvf", "embed"), ("pouring_mvf", "project"),
               ("pouring_mvf", "padded"), ("vit_dynamic_cls_res", "project"),
               ("vit_dynamic_cls_res", "padded"), ("rn50_lstp3", "padded")]


@pytest.mark.parametrize("mvf_model, mode", MODEL_MODES, indirect=["mvf_model"])
def test_mvf_model_matches_jax(mvf_model, mode):
    jmodel, variables, model, x, _ = mvf_model
    n = 4 if mode == "padded" else T
    masks = np.zeros((1, 1, T), np.float32)
    masks[..., :n] = 1
    kw = dict(project=mode == "project")
    want = np.asarray(jax.jit(lambda v, a, m: jmodel.apply(
        v, a, T, video_masks=m, train=False, true_seq_len=jnp.int32(n), **kw))(
            variables, jnp.asarray(x), jnp.asarray(masks)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), T, video_masks=torch.from_numpy(masks),
                    true_seq_len=n, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=MODEL_ATOL)


@pytest.mark.parametrize("mvf_model", ["pouring_mvf", "vit_dynamic_cls_res"],
                         indirect=True)
def test_mvf_backbone_flat_matches_jax(mvf_model):
    jmodel, variables, model, x, _ = mvf_model
    feats, cls = jax.jit(lambda v, a: jmodel.apply(v, a, method="backbone_flat"))(
        variables, jnp.asarray(x[0]))
    with torch.inference_mode():
        tfeats, tcls = model.backbone_flat(torch.from_numpy(x[0]))
    # the taps' channels on the 4x4 patch grid, and the final-norm CLS
    assert tfeats.shape == (T, 4, 4, model.spec.out_channel)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(feats), atol=MODEL_ATOL)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(cls), atol=MODEL_ATOL)


def test_unported_vit_wirings_raise(test_vit):
    # a partially frozen ViT builds now (tests/test_torch_vit_partial.py)
    partial = build_model(small_mvf_cfg(port_config, ["MODEL.BASE_MODEL.LAYER", "1"]))
    assert isinstance(partial.res_finetune, port_vit.ViTBackEnd)
    # late fusion over a ViT builds too (tests/test_torch_late_vit.py)
    late = build_model(small_mvf_cfg(port_config, ["MODEL.EMBEDDER_MODEL.FUSION_TYPE",
                                                   "late"]))
    assert late.spec.fusion_type == "late" and late.spec.late_type == "cls"
    for opts, what in ((["MODEL.EMBEDDER_TYPE", "conv"], "EMBEDDER_TYPE conv"),
                       (["MODEL.QUANTIZE_BACKBONE", "True"], "QUANTIZE_BACKBONE"),
                       (["MODEL.TRAIN_BASE", "train_all"], "train_all")):
        with pytest.raises(NotImplementedError, match=what):
            build_model(small_mvf_cfg(port_config, opts))


def test_evaluate_cli_runs_mvf_on_cpu(test_vit, tmp_path):
    """`evaluate.main --device cpu` on a shrunk pouring_mvf.yml (USE_AMP
    kept: the ViT runs in bf16) over the synthetic set: finite metrics, and
    one unit-norm 128-d embedding per frame from the checkpoint it loads."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.evaluation.embedding import \
        get_embeddings_dataset

    make_pouring(str(tmp_path / "pouring"), num_train=3, num_val=2, min_len=10,
                 max_len=14, size=40, seed=0)
    logdir = str(tmp_path / "logs")
    opts = ["IMAGE_SIZE", str(S), "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}",
            "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
            "MODEL.EMBEDDER_MODEL.D_FF", "48", "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
            "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
            "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1",
            "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
            "DATA.NUM_WORKERS", "0", "EVAL.FRAMES_PER_BATCH", "8",
            "EVAL.TASKS", "[kendalls_tau,retrieval]"]
    argv = ["--workdir", str(tmp_path), "--logdir", logdir, "--cfg_file", MVF_CFG,
            "--device", "cpu", "--opts", *opts]
    cfg = cli.load_config(cli.parse_cli(argv)[0])
    torch.manual_seed(0)
    save_checkpoint(build_model(cfg), logdir, 0)
    metrics = cli.main(argv)
    assert set(metrics) == {"kendalls_tau", "retrieval"}
    assert all(np.isfinite(v["pouring"]) for v in metrics.values()), metrics

    cfg.PATH_TO_DATASET = str(tmp_path / "pouring")
    model = build_model(cfg)
    load_checkpoint(model, logdir)
    out = get_embeddings_dataset(cfg, model, cli.build_eval_loaders(cfg, "val")[0],
                                 "cpu")
    embs = np.concatenate(out["embs"])
    assert embs.shape == (sum(out["seq_lens"]), 128)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=1), 1.0, atol=1e-5)
