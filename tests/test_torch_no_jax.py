"""The port runs where JAX, flax and sklearn are absent (the GPU machine has
none of flax and sklearn): in a subprocess that blocks all three, import the
port and run a tiny CPU evaluation, from the `.npy` loaders through the model
to the two scipy-only tasks."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "flax", "sklearn"):
        sys.modules[name] = None  # any import of them raises ImportError

    import numpy as np
    import torch

    from video_rep_learning_tpu.config import get_cfg
    from video_rep_learning_tpu_torch.evaluate import build_eval_loaders
    from video_rep_learning_tpu_torch.evaluation import get_tasks
    from video_rep_learning_tpu_torch.evaluation.evaluate import evaluate_once
    from video_rep_learning_tpu_torch.models import build_model

    torch.set_num_threads(1)
    cfg = get_cfg()
    cfg.PATH_TO_DATASET = sys.argv[1]
    cfg.IMAGE_SIZE = 32
    cfg.DATA.NUM_WORKERS = 0
    cfg.EVAL.FRAMES_PER_BATCH = 16
    cfg.EVAL.TASKS = ["kendalls_tau", "retrieval"]
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = 1, [[32, True]], 1
    e.HIDDEN_SIZE, e.D_FF, e.EMBEDDING_SIZE = 32, 64, 16
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    iterator_tasks, tasks = get_tasks(cfg)
    metrics = evaluate_once(cfg, model, build_eval_loaders(cfg, "train"),
                            build_eval_loaders(cfg, "val"), iterator_tasks,
                            tasks, 0, None, "cpu")
    assert set(metrics) == {"kendalls_tau", "retrieval"}, metrics
    assert all(np.isfinite(v["pouring"]) for v in metrics.values()), metrics
    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "flax", "sklearn"))
    assert not loaded, loaded
    print("NO_JAX_OK", metrics)
""")


def test_port_runs_without_jax_flax_sklearn(tmp_path):
    data = str(tmp_path / "pouring")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_data.py"),
         "--out", data, "--num_train", "3", "--num_val", "3",
         "--min_len", "20", "--max_len", "30", "--size", "40",
         "--format", "npy"], check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    res = subprocess.run([sys.executable, "-c", SCRIPT, data], cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
