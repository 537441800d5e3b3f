"""The port's embedding sweep, `evaluate_once` and CLI against the JAX
package's, on the `.npy` synthetic Pouring set and the micro CARL model of
`tests/test_eval.py` (full ResNet-50 depth, 32 px), at the same weights: the
JAX trainer's, with perturbed BN statistics, exported by
`export_carl_checkpoint` and loaded by the port's `load_checkpoint`."""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_rep_learning_tpu.evaluation import get_tasks as jax_get_tasks
from video_rep_learning_tpu.evaluation.embedding import \
    get_embeddings_dataset as jax_get_embeddings_dataset
from video_rep_learning_tpu.evaluation.evaluate import \
    evaluate_once as jax_evaluate_once
from video_rep_learning_tpu.models.import_torch import export_carl_checkpoint
from video_rep_learning_tpu_torch.evaluate import build_eval_loaders
from video_rep_learning_tpu_torch.evaluation import get_tasks
from video_rep_learning_tpu_torch.evaluation.embedding import get_embeddings_dataset
from video_rep_learning_tpu_torch.evaluation.evaluate import evaluate_once
from video_rep_learning_tpu_torch.models import build_model, load_checkpoint

from tests.test_torch_model import perturb_batch_stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# embeddings are unit-norm fp32 through 53 convolutions summed in another
# order; the JAX sweep also pads chunks to its buckets (masked), which moves
# the valid frames by ~1e-6
EMB_ATOL = 1e-4
# tau, retrieval AP and probe accuracy are counts of discrete decisions
# (nearest neighbours, top-K, argmax). The two packages' embeddings differ by
# ~1e-6 here, while the smallest gap between competing squared distances on
# this set is ~1e-4, so no decision flips. Event completion is a
# least-squares R^2, continuous in the embeddings, whose conditioning scales
# their ~1e-6 differences up to ~1e-5
METRIC_ATOL = {"kendalls_tau": 1e-6, "retrieval": 1e-6,
               "classification": 1e-6, "event_completion": 1e-4}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from tests.test_train import micro_cfg
    from video_rep_learning_tpu.train import Trainer

    root = tmp_path_factory.mktemp("torch_eval")
    data = str(root / "pouring")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_data.py"),
         "--out", data, "--num_train", "4", "--num_val", "3",
         "--min_len", "20", "--max_len", "40", "--size", "40",
         "--format", "npy"], check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    logdir = str(root / "logs")
    os.makedirs(os.path.join(logdir, "checkpoints"))
    cfg = micro_cfg(data, logdir)
    cfg.EVAL.FRAMES_PER_BATCH = 16  # several chunks per 20-40 frame video
    tr = Trainer(cfg)
    tr.init_state()
    variables = {"params": tr.params,
                 "batch_stats": perturb_batch_stats(tr.state["batch_stats"], 7)}
    export_carl_checkpoint(
        os.path.join(logdir, "checkpoints", "checkpoint_epoch_00000.pth"),
        variables, cfg.MODEL.BASE_MODEL.LAYER, cfg=cfg)
    model = build_model(cfg)
    epoch = load_checkpoint(model, logdir)
    assert epoch == 0
    return cfg, tr, variables, model, root


def test_embeddings_match_jax(setup):
    cfg, tr, variables, model, _ = setup
    ref = jax_get_embeddings_dataset(cfg, tr.model, variables,
                                     tr.val_emb_loader[0])
    out = get_embeddings_dataset(cfg, model, build_eval_loaders(cfg, "val")[0],
                                 "cpu")
    assert out["names"] == ref["names"]
    assert out["seq_lens"] == ref["seq_lens"]
    for a, b, la, lb in zip(out["embs"], ref["embs"], out["labels"],
                            ref["labels"]):
        assert a.shape == b.shape and a.shape[1] == 16
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_allclose(a, b, atol=EMB_ATOL)
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
    # no unintended work: one embedding per frame, the loader's order
    assert sum(len(e) for e in out["embs"]) == sum(out["seq_lens"])


def test_evaluate_once_matches_jax(setup):
    cfg, tr, variables, model, _ = setup
    _, jax_tasks = jax_get_tasks(cfg)
    ref = jax_evaluate_once(cfg, tr.model, variables, tr.train_emb_loader,
                            tr.val_emb_loader, {}, jax_tasks, 0, None)
    iterator_tasks, tasks = get_tasks(cfg)
    out = evaluate_once(cfg, model, build_eval_loaders(cfg, "train"),
                        build_eval_loaders(cfg, "val"), iterator_tasks, tasks,
                        0, None, "cpu")
    assert set(out) == {"kendalls_tau", "retrieval", "classification",
                        "event_completion"} == set(ref)
    for task in out:
        np.testing.assert_allclose(out[task]["pouring"], ref[task]["pouring"],
                                   atol=METRIC_ATOL[task], err_msg=task)


def test_cli_runs_on_exported_checkpoint(setup):
    """`python -m video_rep_learning_tpu_torch.evaluate --device cpu` on the
    checkpoint `export_carl_checkpoint` wrote: the same metrics lines."""
    cfg, _, _, model, root = setup
    cfg = copy.deepcopy(cfg)
    cfg_file = str(root / "cli_cfg.yml")
    with open(cfg_file, "w") as f:
        f.write(cfg.to_yaml())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "video_rep_learning_tpu_torch.evaluate",
         "--workdir", str(root), "--cfg_file", cfg_file, "--logdir",
         cfg.LOGDIR, "--device", "cpu", "--opts", "EVAL.TASKS",
         "[kendalls_tau,retrieval]"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = dict(re.findall(r"metrics/all_(\w+): ([-\d.]+)", res.stdout))
    assert set(got) == {"kendalls_tau", "retrieval"}
    cfg.EVAL.TASKS = ["kendalls_tau", "retrieval"]
    iterator_tasks, tasks = get_tasks(cfg)
    ref = evaluate_once(cfg, model, build_eval_loaders(cfg, "train"),
                        build_eval_loaders(cfg, "val"), iterator_tasks, tasks,
                        0, None, "cpu")
    for task, v in got.items():
        assert abs(float(v) - ref[task]["pouring"]) <= 5e-5, task
