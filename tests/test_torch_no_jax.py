"""The port runs where JAX, flax and sklearn are absent (the GPU machine has
none of flax and sklearn) and without the JAX package: in a subprocess that
blocks all four, import the port and run a tiny CPU evaluation, from the
`.npy` loaders through the model to the two scipy-only tasks, then two
training steps, then an MV-Former evaluation (`configs_mvf/pouring_mvf.yml`
with a small test ViT), one MV-Former training step, and one step of the
same model frozen up to block 1 of 2 under MODEL.REMAT (the back end
trains, the front stays)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = ("jax", "flax", "sklearn", "video_rep_learning_tpu")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of them raises ImportError

    import numpy as np
    import torch

    from video_rep_learning_tpu_torch.config import get_cfg
    from video_rep_learning_tpu_torch.evaluate import build_eval_loaders
    from video_rep_learning_tpu_torch.evaluation import get_tasks
    from video_rep_learning_tpu_torch.evaluation.evaluate import evaluate_once
    from video_rep_learning_tpu_torch.models import build_model
    from video_rep_learning_tpu_torch.train import Trainer

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

    cfg.TRAIN.NUM_FRAMES = 6
    cfg.TRAIN.BATCH_SIZE = 1
    cfg.USE_AMP = False
    trainer = Trainer(cfg, no_eval=True, device="cpu")
    trainer.train_loader.set_epoch(0)
    before = [p.detach().clone() for _, p in trainer.model.named_parameters()]
    losses = []
    for it, batch in zip(range(2), trainer.train_loader):
        losses.append(float(trainer.train_step(
            batch, trainer.device_batch(batch), 0, it, 1e-3)))
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    moved = [not torch.equal(a, p) for a, (n, p) in
             zip(before, trainer.model.named_parameters())]
    assert any(moved)

    from video_rep_learning_tpu_torch.config import load_yaml_into
    from video_rep_learning_tpu_torch.models import vit

    vit.VIT_SPECS["vit_test_64"] = vit.ViTSpec(64, 1, 1, 8, img_size=32)
    mvf = get_cfg()
    load_yaml_into(mvf, "configs_mvf/pouring_mvf.yml")
    mvf.PATH_TO_DATASET = sys.argv[1]
    mvf.IMAGE_SIZE = 32
    mvf.DATA.NUM_WORKERS = 0
    mvf.EVAL.TASKS = ["kendalls_tau", "retrieval"]
    mvf.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_test_64"
    e = mvf.MODEL.EMBEDDER_MODEL
    e.SMART_FEATS, e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = "0", 1, [[32, True]], 1
    e.HIDDEN_SIZE, e.D_FF, e.SMART_POOL_CHANNELS = 32, 64, 16
    model = build_model(mvf, "cpu")
    iterator_tasks, tasks = get_tasks(mvf)
    mvf_metrics = evaluate_once(mvf, model, build_eval_loaders(mvf, "train"),
                                build_eval_loaders(mvf, "val"), iterator_tasks,
                                tasks, 0, None, "cpu")
    assert all(np.isfinite(v["pouring"]) for v in mvf_metrics.values()), mvf_metrics

    mvf.TRAIN.NUM_FRAMES = 4
    mvf_trainer = Trainer(mvf, no_eval=True, device="cpu")
    mvf_trainer.train_loader.set_epoch(0)
    vit_before = {n: t.clone() for n, t in mvf_trainer.model.state_dict().items()
                  if n.startswith("backbone.")}
    batch = next(iter(mvf_trainer.train_loader))
    mvf_loss = float(mvf_trainer.train_step(batch, mvf_trainer.device_batch(batch),
                                            0, 0, 1e-3))
    assert np.isfinite(mvf_loss), mvf_loss
    state = mvf_trainer.model.state_dict()
    assert all(torch.equal(state[n], t) for n, t in vit_before.items())

    vit.VIT_SPECS["vit_test_64_d2"] = vit.ViTSpec(64, 2, 1, 8, img_size=32)
    mvf.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_test_64_d2"
    mvf.MODEL.BASE_MODEL.LAYER = 1
    mvf.MODEL.REMAT = True
    mvf.MODEL.EMBEDDER_MODEL.SMART_FEATS = "1"
    part = Trainer(mvf, no_eval=True, device="cpu")
    part.train_loader.set_epoch(0)
    before = {n: t.clone() for n, t in part.model.state_dict().items()}
    batch = next(iter(part.train_loader))
    part_loss = float(part.train_step(batch, part.device_batch(batch), 0, 0, 1e-3))
    assert np.isfinite(part_loss), part_loss
    state = part.model.state_dict()
    assert all(torch.equal(state[n], t) for n, t in before.items()
               if n.startswith("backbone."))
    assert not torch.equal(state["res_finetune.blocks.1.mlp.fc1.weight"],
                           before["res_finetune.blocks.1.mlp.fc1.weight"])
    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK", metrics, mvf_metrics, mvf_loss, part_loss)
""")


def test_port_runs_without_jax_flax_sklearn(tmp_path):
    data = str(tmp_path / "pouring")
    subprocess.run(
        [sys.executable, "-m", "video_rep_learning_tpu_torch.data.synthetic",
         "--out", data, "--num_train", "3", "--num_val", "3",
         "--min_len", "20", "--max_len", "30", "--size", "40"],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    res = subprocess.run([sys.executable, "-c", SCRIPT, data], cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
