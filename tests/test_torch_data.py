"""The port's own data modules against the JAX package's: the synthetic set
generator writes the same files as `tools/make_synthetic_data.py`, and the
port's loaders yield the same batches, epoch by epoch, as the JAX package's
on it (the same seed, the same shuffles, the same sampled frames)."""

import ast
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from video_rep_learning_tpu.config import get_cfg as jax_get_cfg
from video_rep_learning_tpu.data import construct_dataloader as jax_construct
from video_rep_learning_tpu_torch.config import get_cfg
from video_rep_learning_tpu_torch.data import construct_dataloader
from video_rep_learning_tpu_torch.data.synthetic import make_pouring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    make_pouring(str(root / "port" / "pouring"), num_train=4, num_val=2,
                 min_len=20, max_len=40, size=40, seed=5)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_data.py"),
         "--out", str(root / "tool" / "pouring"), "--num_train", "4",
         "--num_val", "2", "--min_len", "20", "--max_len", "40", "--size", "40",
         "--format", "npy", "--seed", "5"],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    return root


def test_synthetic_set_matches_the_tool(sets):
    for split in ("train", "val"):
        with open(sets / "port" / "pouring" / f"{split}.pkl", "rb") as f:
            port = pickle.load(f)
        with open(sets / "tool" / "pouring" / f"{split}.pkl", "rb") as f:
            tool = pickle.load(f)
        assert len(port) == len(tool)
        for a, b in zip(port, tool):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(
                np.load(sets / "port" / "pouring" / a["video_file"]),
                np.load(sets / "tool" / "pouring" / b["video_file"]))


def _cfg(get, root):
    cfg = get()
    cfg.PATH_TO_DATASET = str(root / "port" / "pouring")
    cfg.TRAIN.NUM_FRAMES = 8
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.EVAL.BATCH_SIZE = 2
    cfg.DATA.NUM_WORKERS = 2
    return cfg


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "names":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_loaders_yield_the_jax_packages_batches(sets, split):
    loader, emb = construct_dataloader(_cfg(get_cfg, sets), split)
    jloader, jemb = jax_construct(_cfg(jax_get_cfg, sets), split)
    assert len(loader) == len(jloader) > 0
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for a, b in zip(loader, jloader):
            assert a["videos"].shape[:3] == (2, 2, 8)  # B, views, frames
            _assert_same(a, b)
    assert len(emb) == len(jemb) == 1
    for a, b in zip(emb[0], jemb[0]):
        _assert_same(a, b)


def test_rank_comes_from_torch_distributed(sets, tmp_path):
    """With a process group of two ranks, each rank's loader takes its own
    half of the shuffled clips."""
    code = (
        "import sys, torch.distributed as dist\n"
        "from video_rep_learning_tpu_torch.config import get_cfg\n"
        "from video_rep_learning_tpu_torch.data import construct_dataloader\n"
        "rank = int(sys.argv[1])\n"
        "dist.init_process_group('gloo', init_method='file://' + sys.argv[2],\n"
        "                        world_size=2, rank=rank)\n"
        "cfg = get_cfg()\n"
        "cfg.PATH_TO_DATASET = sys.argv[3]\n"
        "cfg.DATA.NUM_WORKERS = 0\n"
        "loader, _ = construct_dataloader(cfg, 'train')\n"
        "print('IDX', [int(i) for i in loader.sampler.indices()])\n"
        "dist.destroy_process_group()\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(tmp_path / "rendezvous"),
         str(sets / "port" / "pouring")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    idx = [ast.literal_eval(o.split("IDX ")[1].strip()) for o, _ in outs]
    assert sorted(idx[0] + idx[1]) == [0, 1, 2, 3] and len(idx[0]) == 2
