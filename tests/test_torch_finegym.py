"""The port's FineGym harness (`evaluation/finegym.py`) against the JAX
package's: the linear probe against `train_linear_probe` on the same
embedding files from the same initial weights (drawn here with the JAX
package's own key calls and handed to the port); the probe's batching (the
10-video floor of a fraction, the train set's dropped tail, the val set's
kept one, fraction 1 alone under the classification algorithm); the whole
harness on a tiny gym99-format set (one pickle per video and split, each
video's embeddings against the JAX package's `dump_embeddings_dataset` on
the same weights, exported with `convert_to_mvf_state_dict`); and the two
ways in: `evaluate.main` and the trainer's `evaluate_fn`.

The whole models use a test-only ViT (64-d, 2 blocks, patch 8 at 32 px)
registered in both packages' `VIT_SPECS`, with a shrunk
`configs_mvf/fg99_mvf.yml` head (6 static LSTP tokens, avg final).

Tolerances: the probe runs fp32 on both sides, the same math summed in
another order: equal accuracy, weights within rtol 1e-5 (atol 1e-6 for
entries near 0). Embeddings as `tests/test_torch_mvformer.py` holds whole
models (5e-5).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_rep_learning_tpu import config as jax_config
from video_rep_learning_tpu.data import construct_dataloader as jax_loaders
from video_rep_learning_tpu.evaluation import finegym as jax_finegym
from video_rep_learning_tpu.models import build_model as jax_build_model
from video_rep_learning_tpu.models import vit as jax_vit
from video_rep_learning_tpu.models.import_torch import convert_to_mvf_state_dict
from video_rep_learning_tpu_torch import config as port_config
from video_rep_learning_tpu_torch.data.decode import encode_video
from video_rep_learning_tpu_torch.evaluation import finegym
from video_rep_learning_tpu_torch.models import (build_model, save_checkpoint,
                                                 state_dict_from_numpy)
from video_rep_learning_tpu_torch.models import vit as port_vit
from video_rep_learning_tpu_torch.models.weights import load_model_state

from tests.test_finegym_eval import _write_emb_files
from tests.test_torch_model import perturb_batch_stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FG_CFG = os.path.join(REPO, "configs_mvf", "fg99_mvf.yml")
TEST_VIT, S, DEPTH = "vit_fg_test_64", 32, 2
EMB_ATOL = 5e-5


class _JaxProxy:
    """The `jax` module as the JAX harness sees it, except that `jax.jit`
    records the arguments of each call of the wrapped function, so the
    probe's parameters after its last evaluation can be read back."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def call(*args):
            self._calls[fn.__name__] = args
            return jitted(*args)

        return call


def _probe_cfg(config_module, classes=4, emb=8, epochs=4):
    cfg = config_module.get_cfg()
    cfg.EVAL.CLASS_NUM = classes
    cfg.EVAL.CLASSIFICATION_LR = 1.0
    cfg.EVAL.CLASSIFICATION_EPOCHS = epochs
    cfg.MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE = emb
    return cfg


def _jax_init(cfg):
    """The JAX probe's initial weights, drawn as `finegym.py:104-109` draws
    them: (w (emb, classes), b (classes,))."""
    emb, classes = cfg.MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE, cfg.EVAL.CLASS_NUM
    bound = 1.0 / np.sqrt(emb)
    k = jax.random.key(cfg.RNG_SEED)
    w = jax.random.uniform(k, (emb, classes), minval=-bound, maxval=bound)
    b = jax.random.uniform(jax.random.fold_in(k, 1), (classes,), minval=-bound,
                           maxval=bound)
    return np.asarray(w), np.asarray(b)


def _overlapping_files(tmp_path, n, seed, tag):
    """Embedding files whose classes overlap, so that the probe's accuracy
    is neither 0 nor 100 and its weights keep moving."""
    files = _write_emb_files(tmp_path, n, 8, 4, seed=seed, tag=tag)
    rng = np.random.RandomState(seed + 100)
    for path in files:
        with open(path, "rb") as f:
            d = pickle.load(f)
        d["embs"] = (d["embs"] / 3 + rng.randn(*d["embs"].shape)).astype(np.float32)
        d["labels"][::7] = -1  # frames the probe drops
        with open(path, "wb") as f:
            pickle.dump(d, f)
    return files


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_probe_matches_jax(tmp_path, monkeypatch, fraction):
    train = _overlapping_files(tmp_path, 25, 0, "tr")
    val = _overlapping_files(tmp_path, 13, 1, "va")
    jcfg, pcfg = _probe_cfg(jax_config), _probe_cfg(port_config)
    calls = {}
    monkeypatch.setattr(jax_finegym, "jax", _JaxProxy(calls))
    want_acc = jax_finegym.train_linear_probe(jcfg, train, val, fraction, 0, None)
    params = calls["eval_correct"][0]  # after the last epoch's training
    w, b = _jax_init(jcfg)
    out = {}
    got_acc = finegym.train_linear_probe(pcfg, train, val, fraction, 0, None, "cpu",
                                         init=(w.T, b), probe_out=out)
    assert 0.0 < got_acc < 100.0
    assert got_acc == want_acc
    probe = out["probe"]
    np.testing.assert_allclose(probe.weight.detach().numpy(),
                               np.asarray(params["w"]).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probe.bias.detach().numpy(), np.asarray(params["b"]),
                               rtol=1e-5, atol=1e-6)


def test_probe_batches(tmp_path, monkeypatch):
    """Fraction 0.1 of 25 train videos still forms one 10-video batch;
    fraction 0.5 keeps 12 and drops the 2 past the batch; the val set's 13
    videos make a batch of 10 and one of 3."""
    train = _overlapping_files(tmp_path, 25, 0, "tr")
    val = _overlapping_files(tmp_path, 13, 1, "va")
    seen = []
    real = finegym._batch
    monkeypatch.setattr(finegym, "_batch", lambda files, idx, device: (
        seen.append((files is val, len(files), sorted(int(i) for i in idx)))
        or real(files, idx, device)))
    cfg = _probe_cfg(port_config, epochs=2)
    for fraction, n_train in ((0.1, 10), (0.5, 12)):
        seen.clear()
        finegym.train_linear_probe(cfg, train, val, fraction, 0, None, "cpu")
        tr = [s for s in seen if not s[0]]
        va = [s for s in seen if s[0]]
        assert [len(s[2]) for s in tr] == [10, 10]  # one batch an epoch
        assert all(s[1] == n_train and max(s[2]) < n_train for s in tr)
        assert [len(s[2]) for s in va] == [10, 3] * 2
        assert all(s[1] == 13 for s in va)
    # an epoch's shuffle is RandomState(RNG_SEED + epoch)'s
    idx = np.arange(25)
    np.random.RandomState(cfg.RNG_SEED + 3).shuffle(idx)
    got = finegym.probe_batches(train, cfg.RNG_SEED, True, 3, True)
    assert [list(b) for b in got] == [list(idx[:10]), list(idx[10:20])]


def test_classification_probes_fraction_one(monkeypatch, tmp_path):
    fractions = []
    monkeypatch.setattr(finegym, "dump_embeddings_dataset", lambda *a: ([], []))
    monkeypatch.setattr(finegym, "train_linear_probe",
                        lambda cfg, tr, va, fraction, *a: fractions.append(fraction))
    for algo, want in (("classification", [1]), ("scl", [0.1, 0.5, 1.0])):
        cfg = port_config.get_cfg()
        cfg.LOGDIR = str(tmp_path)
        cfg.TRAINING_ALGO = algo
        fractions.clear()
        finegym.evaluate_loaders(cfg, torch.nn.Identity(), [], [], 0, None, "cpu")
        assert fractions == want


# ---------------------------------------------------------------------------
# the whole harness on a tiny gym99-format set
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fg_dir(tmp_path_factory):
    """12 train and 4 val videos of 20-36 frames at 40 px, labels 0..98 with
    some frames at -1, in the gym99 pickle layout."""
    out = tmp_path_factory.mktemp("finegym")
    (out / "videos").mkdir()
    rng = np.random.RandomState(0)
    for split, n in (("train", 12), ("val", 4)):
        entries = []
        for i in range(n):
            seq_len = int(rng.randint(20, 37))
            frames = rng.randint(0, 255, size=(seq_len, 40, 40, 3)).astype(np.uint8)
            rel = os.path.join("videos", f"{split}_{i}.npy")
            encode_video(str(out / rel), frames)
            labels = rng.randint(0, 99, seq_len).astype(np.int64)
            labels[rng.rand(seq_len) < 0.2] = -1
            entries.append({"id": i, "name": f"gym/{split}_{i}", "video_file": rel,
                            "frame_label": labels, "seq_len": seq_len})
        name = "gym99_train_v1.0.pkl" if split == "train" else "gym99_val.pkl"
        with open(str(out / name), "wb") as f:
            pickle.dump(entries, f)
    return str(out)


FG_OPTS = [
    "MODEL.BASE_MODEL.NETWORK", f"TIMM-{TEST_VIT}", "IMAGE_SIZE", str(S),
    "USE_AMP", "False", "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "8",
    "MODEL.EMBEDDER_MODEL.SMART_FEATS", "0,1",
    "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
    "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
    "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1",
    "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32",
    "MODEL.EMBEDDER_MODEL.NUM_HEADS", "2",
    "MODEL.EMBEDDER_MODEL.D_FF", "48",
    "MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE", "16",
    "MODEL.EMBEDDER_MODEL.SMART_POOL_CHANNELS", "24",
    "MODEL.PROJECTION_SIZE", "24", "DATA.NUM_WORKERS", "0",
    "EVAL.FRAMES_PER_BATCH", "16", "EVAL.CLASSIFICATION_EPOCHS", "3",
    "EVAL.CLASSIFICATION_LR", "1.0", "TRAIN.NUM_FRAMES", "8"]


def _fg_cfg(config_module, fg_dir, logdir):
    cfg = config_module.get_cfg()
    config_module.load_yaml_into(cfg, FG_CFG)
    config_module.apply_opts(cfg, FG_OPTS)
    cfg.PATH_TO_DATASET = fg_dir
    cfg.LOGDIR = logdir
    return cfg


@pytest.fixture(scope="module")
def fg_models(fg_dir, tmp_path_factory):
    """(JAX model, its variables, the reference dict, the port's model
    loaded from it) on the test ViT."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_SPECS, TEST_VIT, jax_vit.ViTSpec(64, DEPTH, 2, 8, img_size=S))
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT, port_vit.ViTSpec(64, DEPTH, 2, 8, img_size=S))
        logdir = str(tmp_path_factory.mktemp("fg_jax"))
        cfg = _fg_cfg(jax_config, fg_dir, logdir)
        jmodel = jax_build_model(cfg)
        x = np.random.RandomState(4).rand(1, 8, S, S, 3).astype(np.float32)

        def init_all(mdl, x, masks):
            return mdl(x, 8, video_masks=masks, project=True)

        variables = jax.jit(lambda r, a, m: jmodel.init(r, a, m, method=init_all))(
            {"params": jax.random.key(5), "dropout": jax.random.key(6)},
            jnp.asarray(x), jnp.ones((1, 1, 8), jnp.float32))
        variables = {"params": variables["params"],
                     "batch_stats": perturb_batch_stats(variables["batch_stats"], 7)}
        sd = convert_to_mvf_state_dict(variables["params"], variables["batch_stats"],
                                       depth=DEPTH, patch_size=8)
        model = build_model(_fg_cfg(port_config, fg_dir, logdir))
        load_model_state(model, state_dict_from_numpy(sd))
        yield cfg, jmodel, variables, sd, model


def _pickles(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_harness_matches_jax_dump(fg_dir, fg_models, tmp_path):
    """The port's harness end to end: one pickle per video and split under
    the JAX package's file names, each video's embeddings (its frames
    labelled below 0 dropped) against the JAX package's dump, finite
    accuracies in [0, 100] under each fraction."""
    jcfg, jmodel, variables, _, model = fg_models
    pcfg = _fg_cfg(port_config, fg_dir, str(tmp_path / "port"))
    from video_rep_learning_tpu_torch.data import construct_dataloader

    loaders = {s: construct_dataloader(pcfg, s)[1][0] for s in ("train", "val")}
    accs = finegym.evaluate_loaders(pcfg, model, loaders["train"], loaders["val"], 0,
                                    None, "cpu")
    assert sorted(accs) == [0.1, 0.5, 1.0]
    assert all(np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs.values())
    for split, n in (("train", 12), ("val", 4)):
        got = _pickles(os.path.join(pcfg.LOGDIR, f"finegym_eval_{split}set"))
        want_dir = str(tmp_path / f"jax_{split}")
        jax_finegym.dump_embeddings_dataset(jcfg, jmodel, variables,
                                            jax_loaders(jcfg, split)[1][0], want_dir)
        want = _pickles(want_dir)
        assert sorted(got) == sorted(want) and len(got) == n
        assert all(k.startswith("gym_") for k in got)
        for name, rec in got.items():
            assert rec["name"] == want[name]["name"]
            assert rec["embs"].shape[1] == 16 and np.isfinite(rec["embs"]).all()
            np.testing.assert_array_equal(rec["labels"], want[name]["labels"])
            assert (rec["labels"] >= 0).all()
            np.testing.assert_allclose(rec["embs"], want[name]["embs"], atol=EMB_ATOL)


def test_evaluate_main_and_trainer_fn_run_finegym(fg_dir, fg_models, tmp_path):
    """`evaluate.main --device cpu` on a FineGym config runs the harness from
    the newest checkpoint, and so does the trainer's `evaluate_fn`."""
    from video_rep_learning_tpu_torch import evaluate as cli
    from video_rep_learning_tpu_torch import evaluate_finegym
    from video_rep_learning_tpu_torch.evaluation.evaluate import \
        make_trainer_evaluate_fn
    from video_rep_learning_tpu_torch.train import Trainer

    _, _, _, sd, model = fg_models
    assert evaluate_finegym.main is cli.main
    logdir = str(tmp_path / "logs")
    save_checkpoint(model, logdir, 2)
    argv = ["--workdir", "/", "--logdir", logdir, "--cfg_file", FG_CFG,
            "--device", "cpu", "--opts", *FG_OPTS, "PATH_TO_DATASET",
            fg_dir.lstrip("/")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_vit.VIT_SPECS, TEST_VIT, port_vit.ViTSpec(64, DEPTH, 2, 8, img_size=S))
        accs = cli.main(argv)
        assert sorted(accs) == [0.1, 0.5, 1.0]
        dumped = os.listdir(os.path.join(logdir, "finegym_eval_valset"))
        assert len(dumped) == 4

        cfg = _fg_cfg(port_config, fg_dir, str(tmp_path / "trainer"))
        trainer = Trainer(cfg, device="cpu")
        load_model_state(trainer.model, state_dict_from_numpy(sd))
        got = make_trainer_evaluate_fn(None)(trainer, 0)
    assert got == accs  # the same weights, embeddings and probe
    assert len(os.listdir(os.path.join(cfg.LOGDIR, "finegym_eval_trainset"))) == 12
