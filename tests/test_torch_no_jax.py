"""The port runs where JAX, flax and sklearn are absent (the GPU machine has
none of flax and sklearn) and without the JAX package: in a subprocess that
blocks all four, import the port (its micro-benchmark tools too) and run a
tiny CPU evaluation, from the `.npy` loaders through the model to the
default four tasks (their linear probes are the port's numpy + scipy
ones), then two
training steps and one through the device prefetch, a TCC epoch of `configs/tcc_config.yml`'s conv model (the
supervised augmentation, train_all) and its NUM_CONTEXTS 2 evaluation,
then an MV-Former evaluation (`configs_mvf/pouring_mvf.yml`
with a small test ViT) and its frame-packed sweep, one MV-Former training step, and one step of the
same model frozen up to block 1 of 2 under MODEL.REMAT (the back end
trains, the front stays), the late-fusion ViT ablations' evaluation
(`configs_mvf/ablate_dinoB8_{max,cls}.yml` on the small ViT), and the
FineGym harness (`configs_mvf/fg99_mvf.yml` on a tiny gym99-format set:
embedding pickles and the linear probe). matplotlib is blocked as well: the
bench (`bench.main --device cpu --device-only`: one JSON line), the LSTP
hook capture on the MV-Former and the alignment (nearest neighbour and DTW)
and retrieval top-K on its embeddings run without it."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = ("jax", "flax", "sklearn", "video_rep_learning_tpu", "matplotlib")
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
    from video_rep_learning_tpu_torch.tools import (  # noqa: F401
        bench_attn_variants, bench_eval, bench_host_pipeline, bench_int8_pallas,
        bench_ln_matmul, bench_packed_attn, bench_vpu_bf16, profile_carl_budget,
        profile_step, sweep_frames_per_batch)
    from video_rep_learning_tpu_torch import (  # noqa: F401
        bench, make_job, read_results, visualize_alignment, visualize_lstp,
        visualize_retrieval)

    torch.set_num_threads(1)
    cfg = get_cfg()
    cfg.PATH_TO_DATASET = sys.argv[1]
    cfg.IMAGE_SIZE = 32
    cfg.DATA.NUM_WORKERS = 0
    cfg.EVAL.FRAMES_PER_BATCH = 16  # EVAL.TASKS: the default four
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = 1, [[32, True]], 1
    e.HIDDEN_SIZE, e.D_FF, e.EMBEDDING_SIZE = 32, 64, 16
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    iterator_tasks, tasks = get_tasks(cfg)
    metrics = evaluate_once(cfg, model, build_eval_loaders(cfg, "train"),
                            build_eval_loaders(cfg, "val"), iterator_tasks,
                            tasks, 0, None, "cpu")
    assert set(metrics) == {"kendalls_tau", "retrieval", "classification",
                            "event_completion"}, metrics
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
    # one step through the device prefetch (DATA.DEVICE_PREFETCH 2, the
    # default): the worker thread's copy, then the step
    from contextlib import closing
    assert trainer.cfg.DATA.DEVICE_PREFETCH == 2
    with closing(trainer.batch_stream()) as batches:
        it, host, dev, h2d_s = next(batches)
        prefetch_loss = float(trainer.train_step(host, dev, 0, it, 1e-3))
    assert np.isfinite(prefetch_loss) and "videos" not in host, prefetch_loss
    assert trainer.prefetcher is not None

    bench_result = bench.main(["--device", "cpu", "--device-only"])
    assert bench_result["value"] > 0 and bench_result["mvf_value"] > 0, bench_result

    from video_rep_learning_tpu_torch.config import load_yaml_into
    from video_rep_learning_tpu_torch.models import vit

    tcc = get_cfg()
    load_yaml_into(tcc, "configs/tcc_config.yml")
    tcc.PATH_TO_DATASET = sys.argv[1]
    tcc.IMAGE_SIZE, tcc.USE_AMP = 32, False
    tcc.DATA.NUM_WORKERS = 0
    tcc.TRAIN.NUM_FRAMES = 4
    tcc.EVAL.FRAMES_PER_BATCH = 8
    tcc.EVAL.TASKS = ["kendalls_tau", "retrieval"]
    e = tcc.MODEL.EMBEDDER_MODEL
    e.CONV_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = [[8, 1, 0]], [[16, True]], 1
    e.EMBEDDING_SIZE = 8
    tcc_trainer = Trainer(tcc, no_eval=True, device="cpu")
    tcc_loss = tcc_trainer.train_one_epoch(0)["loss"]
    assert np.isfinite(tcc_loss) and tcc_loss != 0.0, tcc_loss
    iterator_tasks, tasks = get_tasks(tcc)
    tcc_metrics = evaluate_once(tcc, tcc_trainer.model.eval(),
                                build_eval_loaders(tcc, "train"),
                                build_eval_loaders(tcc, "val"), iterator_tasks,
                                tasks, 0, None, "cpu")
    assert all(np.isfinite(v["pouring"]) for v in tcc_metrics.values()), tcc_metrics

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
    # the frame-packed sweep (EVAL.FLAT_EXTRACT) over the val videos
    from video_rep_learning_tpu_torch.evaluation.embedding import (
        eval_sweep, get_embeddings_dataset)
    mvf.EVAL.FLAT_EXTRACT = True
    assert eval_sweep(mvf, model) == "flat"
    flat = get_embeddings_dataset(mvf, model, build_eval_loaders(mvf, "val")[0], "cpu")
    assert sum(e.shape[0] for e in flat["embs"]) > 0
    assert all(np.isfinite(e).all() for e in flat["embs"])
    mvf.EVAL.FLAT_EXTRACT = False
    # the LSTP hook capture, then alignment and retrieval on the embeddings
    item = next(iter(build_eval_loaders(mvf, "val")[0]))
    att = visualize_lstp.capture_lstp_attention(model, item["video"][:5], item["dims"],
                                                32, "cpu")
    assert att.shape == (5, 3, 16) and np.allclose(att.sum(-1), 1.0, atol=1e-5)
    assert not model.embed.pooling._forward_hooks
    for use_dtw in (False, True):
        nns = visualize_alignment.align(flat["embs"][0], flat["embs"][1], use_dtw)
        assert nns.shape == (flat["embs"][0].shape[0],)
    top = visualize_retrieval.retrieve(flat["embs"][0], np.concatenate(flat["embs"][1:]), 2)
    assert top.shape == (flat["embs"][0].shape[0], 2)

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
    late_metrics = {}
    for kind in ("max", "cls"):
        late = get_cfg()
        load_yaml_into(late, f"configs_mvf/ablate_dinoB8_{kind}.yml")
        late.DATASETS, late.PATH_TO_DATASET = ["pouring"], sys.argv[1]
        late.IMAGE_SIZE, late.DATA.NUM_WORKERS = 32, 0
        late.EVAL.TASKS = ["kendalls_tau", "retrieval"]
        late.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_test_64_d2"
        e = late.MODEL.EMBEDDER_MODEL
        e.SMART_FEATS, e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = "0,1", 1, [[32, True]], 1
        e.HIDDEN_SIZE, e.D_FF = 32, 64
        model = build_model(late, "cpu")
        assert model.spec.fusion_type == "late"
        iterator_tasks, tasks = get_tasks(late)
        late_metrics[kind] = evaluate_once(
            late, model, build_eval_loaders(late, "train"),
            build_eval_loaders(late, "val"), iterator_tasks, tasks, 0, None, "cpu")
        assert all(np.isfinite(v["pouring"]) for v in late_metrics[kind].values())

    import os, pickle
    from video_rep_learning_tpu_torch.data.decode import encode_video
    from video_rep_learning_tpu_torch.evaluation import finegym
    fg_root = sys.argv[2]
    os.makedirs(os.path.join(fg_root, "videos"))
    rng = np.random.RandomState(0)
    for split, n in (("train", 10), ("val", 2)):
        entries = []
        for i in range(n):
            rel = os.path.join("videos", f"{split}_{i}.npy")
            encode_video(os.path.join(fg_root, rel),
                         rng.randint(0, 255, (12, 40, 40, 3)).astype(np.uint8))
            entries.append({"id": i, "name": f"{split}_{i}", "video_file": rel,
                            "frame_label": rng.randint(-1, 99, 12), "seq_len": 12})
        name = "gym99_train_v1.0.pkl" if split == "train" else "gym99_val.pkl"
        with open(os.path.join(fg_root, name), "wb") as f:
            pickle.dump(entries, f)
    fg = get_cfg()
    load_yaml_into(fg, "configs_mvf/fg99_mvf.yml")
    fg.PATH_TO_DATASET, fg.LOGDIR = fg_root, os.path.join(fg_root, "logs")
    fg.IMAGE_SIZE, fg.DATA.NUM_WORKERS, fg.USE_AMP = 32, 0, False
    fg.EVAL.CLASSIFICATION_EPOCHS, fg.EVAL.FRAMES_PER_BATCH = 2, 16
    fg.MODEL.BASE_MODEL.NETWORK = "TIMM-vit_test_64"
    e = fg.MODEL.EMBEDDER_MODEL
    e.SMART_FEATS, e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = "0", 1, [[32, True]], 1
    e.HIDDEN_SIZE, e.D_FF, e.SMART_POOL_CHANNELS = 32, 64, 16
    fg_accs = finegym.evaluate_loaders(
        fg, build_model(fg, "cpu"), build_eval_loaders(fg, "train")[0],
        build_eval_loaders(fg, "val")[0], 0, None, "cpu")
    assert sorted(fg_accs) == [0.1, 0.5, 1.0], fg_accs
    assert len(os.listdir(os.path.join(fg.LOGDIR, "finegym_eval_trainset"))) == 10

    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK", metrics, tcc_metrics, mvf_metrics, mvf_loss, part_loss,
          late_metrics, fg_accs, bench_result)
""")


def test_port_runs_without_jax_flax_sklearn(tmp_path):
    data = str(tmp_path / "pouring")
    subprocess.run(
        [sys.executable, "-m", "video_rep_learning_tpu_torch.data.synthetic",
         "--out", data, "--num_train", "3", "--num_val", "3",
         "--min_len", "20", "--max_len", "30", "--size", "40"],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    res = subprocess.run([sys.executable, "-c", SCRIPT, data, str(tmp_path / "gym")],
                         cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


@pytest.mark.timeout(300)
def test_two_ranks_train_without_jax_flax_sklearn(tmp_path):
    from tests.test_torch_parallel import run_ranks

    res = [r for _, _, r in run_ranks("_rank_two_steps_blocked", tmp_path,
                                      block_jax=True)]
    for r in res:
        assert r["loaded"] == [] and all(np.isfinite(r["losses"]))
    for k, v in res[0]["state"].items():
        np.testing.assert_array_equal(res[1]["state"][k], v, err_msg=k)
