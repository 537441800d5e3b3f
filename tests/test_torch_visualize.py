"""The port's visualizers, DTW, `read_results` and `make_job` against the
root JAX scripts:

- `utils/dtw.py` against `video_rep_learning_tpu/utils/dtw.py`: the same
  distance, matrices and path, exactly, ties and 1-row / 1-column inputs
  included;
- `visualize_alignment.align` (nearest neighbour and DTW) and
  `visualize_retrieval.retrieve` give the root scripts' indices, exactly;
- every render function's frames are pixel-identical to the root
  script's on the same inputs (stored as `.npy`);
- the LSTP attention captured by the forward hook on a tiny MV-Former
  (the test ViT, weights from `convert_to_mvf_state_dict`) matches the root
  `capture_lstp_attention` (flax `sow`) within 1e-5, fp32; the chunked
  capture and `run_sweep` follow the root script's chunking and names;
- the three visualizer CLIs run with `--device cpu` over a tiny synthetic
  set and the checkpoint of a port training run, and write their files;
- `read_results` on the logdirs of two port micro runs (a run and its
  `-trial01`) prints what the root script prints;
- `make_job` writes the root script's files, its command the port's CLI.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.models.import_torch import convert_to_mvf_state_dict
from video_rep_learning_tpu.utils.dtw import dtw as jax_dtw
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch import (make_job, read_results, visualize_alignment,
                                          visualize_lstp, visualize_retrieval)
from video_rep_learning_tpu_torch.models import build_model, state_dict_from_numpy
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import load_model_state
from video_rep_learning_tpu_torch.utils.dtw import dtw as port_dtw

from tests.test_torch_mvformer import MVF_CFG, S, TEST_VIT, small_mvf_cfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSTP_ATOL = 1e-5  # fp32 both sides, the same math summed in another order


def _root(name):
    """A root JAX script, loaded by path (it imports matplotlib)."""
    pytest.importorskip("matplotlib")
    spec = importlib.util.spec_from_file_location(f"jax_root_{name}",
                                                  os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- DTW, alignment, retrieval -------------------------------------------------

DTW_SHAPES = [(7, 9), (9, 7), (1, 6), (6, 1), (1, 1), (5, 5)]


@pytest.mark.parametrize("ints", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n, m", DTW_SHAPES)
def test_dtw_matches_jax_exactly(n, m, ints):
    rng = np.random.RandomState(n * 10 + m)
    # small integers make equal costs, so the traceback's tie order shows
    x = rng.randint(0, 3, (n, 2)) if ints else rng.randn(n, 4)
    y = rng.randint(0, 3, (m, 2)) if ints else rng.randn(m, 4)
    got, want = port_dtw(x, y), jax_dtw(x, y)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)


def test_dtw_accepts_1d_sequences():
    x, y = np.arange(5.0), np.array([0.0, 2.0, 2.0, 4.0])
    got, want = port_dtw(x, y), jax_dtw(x, y)
    assert got[0] == want[0]
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_dtw", [False, True], ids=["nn", "dtw"])
def test_align_matches_jax(use_dtw):
    root = _root("visualize_alignment")
    rng = np.random.RandomState(2)
    for n, m in ((12, 17), (17, 12), (1, 5), (5, 1)):
        q, k = rng.randn(n, 8), rng.randn(m, 8)
        np.testing.assert_array_equal(visualize_alignment.align(q, k, use_dtw),
                                      root.align(q, k, use_dtw))


def _rendered(tmp_path, name, fn, *args, **kw):
    out = str(tmp_path / f"{name}.npy")
    fn(*args, out, **kw)
    return np.load(out)


def test_retrieval_matches_jax(tmp_path):
    """The top-K indices against the root script's expression, and the
    rendered strip against its video (distinct random candidate frames, so
    equal frames mean equal indices)."""
    root = _root("visualize_retrieval")
    from scipy.spatial.distance import cdist

    rng = np.random.RandomState(3)
    q_frames = rng.randint(0, 255, (6, 24, 24, 3)).astype(np.uint8)
    q_embs = rng.randn(6, 8)
    cands = [(rng.randint(0, 255, (n, 24, 24, 3)).astype(np.uint8), rng.randn(n, 8))
             for n in (5, 7)]
    cand_embs = np.concatenate([c[1] for c in cands])
    np.testing.assert_array_equal(
        visualize_retrieval.retrieve(q_embs, cand_embs, 3),
        np.argsort(cdist(q_embs, cand_embs, "sqeuclidean"), axis=1)[:, :3])
    got = _rendered(tmp_path, "port", visualize_retrieval.create_retrieval_video,
                    q_frames, q_embs, cands, K=3, stride=2)
    want = _rendered(tmp_path, "jax", root.create_retrieval_video, q_frames, q_embs,
                     cands, K=3, stride=2)
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got, want)


def test_alignment_renders_match_jax(tmp_path):
    root = _root("visualize_alignment")
    rng = np.random.RandomState(1)
    q = rng.randint(0, 255, size=(5, 32, 32, 3)).astype(np.uint8)
    keys = [rng.randint(0, 255, size=(7, 32, 32, 3)).astype(np.uint8) for _ in range(3)]
    nns_list = [np.clip(np.arange(5) + i, 0, 6) for i in range(3)]
    cases = [("pair", "render_pair_video", (q, keys[0], nns_list[0]), {"time_stride": 2}),
             ("multi", "render_multi_video", (q, keys, nns_list), {"time_stride": 2}),
             ("labeled", "render_labeled_video", (q, np.array([0, 0, 1, 1, 2])),
              {"time_stride": 1})]
    for name, fn, args, kw in cases:
        got = _rendered(tmp_path, f"port_{name}", getattr(visualize_alignment, fn),
                        *args, **kw)
        want = _rendered(tmp_path, f"jax_{name}", getattr(root, fn), *args, **kw)
        assert got.ndim == 4 and got.shape[0] == want.shape[0]
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError):
        visualize_alignment.render_multi_video(q, keys * 2, nns_list * 2,
                                               str(tmp_path / "x.npy"))


def test_attention_render_matches_jax(tmp_path):
    root = _root("visualize_lstp")
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 255, (3, 32, 32, 3)).astype(np.uint8)
    att = rng.rand(3, 3, 16).astype(np.float32)
    got = _rendered(tmp_path, "port", visualize_lstp.render_attention_video, frames, att)
    want = _rendered(tmp_path, "jax", root.render_attention_video, frames, att)
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        visualize_lstp.render_attention_video(frames, att[:, :, :15],
                                              str(tmp_path / "x.npy"))


# -- the LSTP capture ----------------------------------------------------------

@pytest.fixture(scope="module")
def test_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_SPECS, TEST_VIT, jax_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT, port_vit.ViTSpec(128, 2, 2, 8, img_size=S))
        yield


@pytest.fixture(scope="module")
def tiny_mvf(test_vit):
    """(JAX model, variables, the port's model loaded from them): the shrunk
    pouring_mvf.yml on the test ViT, 3 static LSTP tokens."""
    cfg = small_mvf_cfg(jax_config)
    jmodel = jax_build_model(cfg)
    x = jnp.zeros((1, 6, S, S, 3), jnp.float32)

    def init_all(mdl, x, masks):
        return mdl(x, 6, video_masks=masks, project=True)

    variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)}, x,
        jnp.ones((1, 1, 6), jnp.float32))
    sd = convert_to_mvf_state_dict(variables["params"], variables["batch_stats"],
                                   depth=2, patch_size=8)
    model = build_model(small_mvf_cfg(port_config))
    load_model_state(model, state_dict_from_numpy(sd))
    return jmodel, variables, model


def test_lstp_capture_matches_jax(tiny_mvf):
    root = _root("visualize_lstp")
    jmodel, variables, model = tiny_mvf
    rng = np.random.RandomState(7)
    video = rng.randint(0, 255, (5, 40, 44, 3)).astype(np.uint8)
    dims = np.array([38.0, 44.0], np.float32)  # a padded canvas
    want = root.capture_lstp_attention(jmodel, variables, video, dims, S)
    got = visualize_lstp.capture_lstp_attention(model, video, dims, S, "cpu")
    assert got.shape == want.shape == (5, 3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LSTP_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    # the hook is gone, and the model's output is the one without it
    assert not model.embed.pooling._forward_hooks


class _PortPool(torch.nn.Module):
    def forward(self, mean):
        return None, mean[:, None, None].expand(-1, 2, 16)


class _PortStub(torch.nn.Module):
    """The root test's stub: the attention is each frame's mean, so the
    concatenation order shows."""

    def __init__(self, calls):
        super().__init__()
        self.calls = calls
        self.embed = torch.nn.Module()
        self.embed.pooling = _PortPool()

    def forward(self, v, num_frames, video_masks=None, project=False):
        self.calls.append(v.shape[1])
        self.embed.pooling(v.mean(dim=(2, 3, 4))[0])


def _jax_stub(calls):
    class StubModel:
        def apply(self, variables, v, num_frames, **kw):
            calls.append(v.shape[1])
            att = np.tile(np.asarray(v).mean(axis=(2, 3, 4))[0][:, None, None], (1, 2, 16))
            return None, {"intermediates": {"embed": {"lstp_attention": [att]}}}
    return StubModel()


def test_lstp_chunked_capture_and_sweep_match_jax(tmp_path):
    from types import SimpleNamespace

    root = _root("visualize_lstp")
    T = 11
    video = np.random.RandomState(2).randint(0, 255, (T, 32, 32, 3)).astype(np.uint8)
    item = {"video": video, "seq_len": T, "dims": (32, 32),
            "labels": np.array([0] * (T - 2) + [-1, -1])}
    pcalls, jcalls = [], []
    att, frames = visualize_lstp.capture_lstp_attention_chunked(
        _PortStub(pcalls), item, 32, 4, "cpu")
    jatt, jframes = root.capture_lstp_attention_chunked(_jax_stub(jcalls), None, item,
                                                        image_size=32, max_fpb=4)
    assert pcalls == jcalls == [4, 4, 3]
    assert att.shape == jatt.shape == (T - 2, 2, 16)
    np.testing.assert_allclose(att, jatt, atol=LSTP_ATOL)
    np.testing.assert_array_equal(frames, jframes)

    items = [dict(item, labels=np.zeros(T, np.int64)) for _ in range(2)]
    for loaders, samples_per in (([items, items], 1), ([items], 2)):
        cfg = SimpleNamespace(LOGDIR=str(tmp_path / f"run{samples_per}"), IMAGE_SIZE=32,
                              EVAL=SimpleNamespace(FRAMES_PER_BATCH=8))
        os.makedirs(cfg.LOGDIR)
        outs = visualize_lstp.run_sweep(cfg, _PortStub([]), loaders, samples_per, "cpu",
                                        max_frames=4)
        want = root.run_sweep(cfg, _jax_stub([]), None, loaders, samples_per,
                              max_frames=4)
        assert outs == want and len(outs) == 2
        assert all(os.path.exists(o) for o in outs)


# -- the CLIs over a port training run ----------------------------------------

CLI_OPTS = ["IMAGE_SIZE", str(S), "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}",
            "TRAIN.NUM_FRAMES", "4", "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "4",
            "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32", "MODEL.EMBEDDER_MODEL.D_FF", "48",
            "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2", "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
            "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
            "MODEL.EMBEDDER_MODEL.SMART_FEATS", "1",
            "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]", "MODEL.PROJECTION_SIZE", "24",
            "USE_AMP", "False", "DATA.NUM_WORKERS", "0", "EVAL.FRAMES_PER_BATCH", "6",
            "EVAL.TASKS", "[kendalls_tau,retrieval]", "TRAIN.MAX_EPOCHS", "1"]


@pytest.fixture(scope="module")
def runs(test_vit, tmp_path_factory):
    """A tiny Pouring set and two one-epoch MV-Former runs of the port's
    training CLI on it (RUN and RUN-trial01, seeds 1 and 2)."""
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.train.cli import main as train_main

    root = tmp_path_factory.mktemp("vis")
    make_pouring(str(root / "pouring"), num_train=2, num_val=3, min_len=10, max_len=13,
                 size=40, seed=0)
    base = str(root / "logs" / "run")
    for logdir, seed in ((base, 1), (base + "-trial01", 2)):
        train_main(["--workdir", str(root), "--logdir", logdir, "--cfg_file", MVF_CFG,
                    "--device", "cpu", "--opts", *CLI_OPTS, "RNG_SEED", str(seed)])
    return str(root), base


def _argv(runs, *extra):
    root, base = runs
    return [*extra, "--workdir", root, "--logdir", base, "--cfg_file", MVF_CFG,
            "--device", "cpu", "--opts", *CLI_OPTS]


def test_alignment_and_retrieval_clis_on_cpu(runs):
    pytest.importorskip("matplotlib")
    _, base = runs
    outs = visualize_alignment.main(_argv(runs, "--use_dtw", "--labeled",
                                          "--time_stride", "4"))
    outs += visualize_alignment.main(_argv(runs, "--keys", "1,2", "--time_stride", "6"))
    outs.append(visualize_retrieval.main(_argv(runs, "--query", "1", "--topk", "2")))
    assert [os.path.basename(o) for o in outs] == [
        "alignment_0_1.mp4", "labeled_0.mp4", "alignment_multi_0.mp4", "retrieval_1.mp4"]
    assert all(os.path.dirname(o) == base and os.path.getsize(o) > 0 for o in outs)


def test_lstp_cli_on_cpu(runs):
    pytest.importorskip("matplotlib")
    _, base = runs
    outs = visualize_lstp.main(_argv(runs, "--max_frames", "3", "--samples_per", "2"))
    outs += visualize_lstp.main(_argv(runs, "--video", "1", "--max_frames", "3"))
    assert [os.path.basename(o) for o in outs] == [
        "lstp_run_sample01.mp4", "lstp_run_sample02.mp4", "lstp_1.mp4"]
    assert all(os.path.getsize(o) > 0 for o in outs)


def test_read_results_matches_jax(runs, capsys):
    root = _root("read_results")
    _, base = runs
    assert read_results.main(["--logdir", base]) == 0
    got = capsys.readouterr().out
    assert root.main(["--logdir", base]) == 0
    want = capsys.readouterr().out
    assert got == want
    assert got.startswith("2 trial(s): ") and "kendalls_tau:" in got


def test_make_job_matches_jax(tmp_path):
    root = _root("make_job")
    tmpl = tmp_path / "job.tmpl"
    tmpl.write_text("#!/bin/bash\n# {name}\nfor R in 0 1; do {command} & done; wait\n")
    for extra in ([], ["--trials", "3", "--seed", "5"], ["--micro", "--trials", "2"],
                  ["--template", str(tmpl)]):
        args = ["--cfg_file", "configs/scl_transformer_config.yml", "--workdir", "/data",
                "--logdir", "/runs/carl", *extra]
        make_job.main([*args, "--out_dir", str(tmp_path / "port")])
        root.main([*args, "--out_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    for name in names:
        got = (tmp_path / "port" / name).read_text()
        want = (tmp_path / "jax" / name).read_text()
        assert got == want.replace(
            "python train.py", "python -m video_rep_learning_tpu_torch.train").replace(
            " --opts ", " --device cuda --opts "), name
        assert os.access(tmp_path / "port" / name, os.X_OK)
