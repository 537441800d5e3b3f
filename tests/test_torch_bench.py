"""The port's bench, step profilers, FRAMES_PER_BATCH sweep and synthetic
data maker against the JAX package's root scripts and tools:

- `bench.carl_cfg` / `k400_cfg` / `mvf_cfg` equal the root `bench.py`'s key
  by key, full width (the port's `cuda`, JAX's TPU) and the CPU shapes, and
  the synthetic batch is the one the root `_measure` stages (captured with
  its trainer and mesh stubbed: nothing of JAX runs);
- `bench.main(["--device", "cpu"])` prints exactly one JSON line with the
  root script's CPU keys and finite values; `cuda` without a card raises;
- `_measure_loader_fed` on the CPU over tiny `.npy` sets (Pouring, and
  K400, whose loader takes a `.npy` store in place of a missing mp4)
  returns a rate and the markers, and leaves the cache switched off;
- `profile_step`, `profile_carl_budget` and `sweep_frames_per_batch` run
  with `--device cpu` and print their tables;
- `data/synthetic.py` and `tools/make_synthetic_data.py` write the same
  files, equal index files and equal frames (each decoded by its own
  package's decoder) for every dataset and format.

Exact comparisons throughout (configs, batches, files, frames). Videos are
64 px wide: the native decoder's RGB conversion corrupts the heap at 40 px
(ROADMAP fault 8)."""

import importlib.util
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_rep_learning_tpu_torch import bench
from video_rep_learning_tpu_torch.data import decode as port_decode
from video_rep_learning_tpu_torch.data import synthetic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_KEYS = {"metric", "value", "unit", "vs_baseline", "mvf_metric", "mvf_value",
            "mvf_vs_baseline"}


def _load_root(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return _load_root("jax_root_bench", "bench.py")


@pytest.mark.parametrize("full", [True, False], ids=["full_width", "cpu_shapes"])
@pytest.mark.parametrize("workload", ["carl", "k400", "mvf"])
def test_bench_configs_match_jax(jax_bench, workload, full):
    want = getattr(jax_bench, f"{workload}_cfg")(full).to_plain()
    got = bench.WORKLOADS[workload]("cuda" if full else "cpu").to_plain()
    assert got == want


@pytest.mark.parametrize("workload", ["carl", "k400"])
def test_synthetic_batch_matches_jax(jax_bench, workload, monkeypatch):
    """The root `_measure`'s batch, taken from its `shard_batch` call with
    its mesh and trainer stubbed."""
    from video_rep_learning_tpu.parallel import mesh
    from video_rep_learning_tpu.train import trainer

    class Stop(Exception):
        pass

    class StubTrainer:
        def __init__(self, *a, **k):
            pass

        def init_state(self):
            pass

        def build_train_step(self):
            return None

    seen = {}

    def capture(_, batch):
        seen.update(batch)
        raise Stop

    monkeypatch.setattr(mesh, "create_mesh", lambda *a, **k: None)
    monkeypatch.setattr(mesh, "shard_batch", capture)
    monkeypatch.setattr(trainer, "Trainer", StubTrainer)
    cfg = getattr(jax_bench, f"{workload}_cfg")(False)
    with pytest.raises(Stop):
        jax_bench._measure(cfg, 1, raw=40)
    got = bench.synthetic_batch(bench.WORKLOADS[workload]("cpu"), 40)
    assert got.keys() == seen.keys()
    for k, v in seen.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_main_prints_one_json_line(capsys):
    result = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 1, out
    parsed = json.loads(lines[0])
    assert parsed == result and set(parsed) == CPU_KEYS
    assert parsed["unit"] == "clips/s/chip"
    for k in ("value", "vs_baseline", "mvf_value", "mvf_vs_baseline"):
        assert math.isfinite(parsed[k]) and parsed[k] > 0, k


def test_bench_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main([])


def test_measure_loader_fed_on_cpu(tmp_path):
    synthetic.make_dataset(str(tmp_path / "pouring"), "pouring", "npy", 2, 1, 12, 16, 40)
    # K400's mp4 names with `.npy` stores in their place (no codec needed)
    synthetic.make_dataset(str(tmp_path / "k400"), "kinetics400", "npy", 2, 0, 12, 16, 40)
    assert sorted(os.listdir(tmp_path / "k400" / "train")) == [
        "synth00000_000000_000010.npy", "synth00001_000000_000010.npy"]
    for cfg_fn, data in ((bench.carl_cfg, "pouring"), (bench.k400_cfg, "k400")):
        for cache_mb in (0, 2048):
            cfg = cfg_fn("cpu")
            cfg.DATA.NUM_WORKERS = 0
            rate, markers = bench._measure_loader_fed(cfg, str(tmp_path / data),
                                                      cache_mb, timed_epochs=1,
                                                      device="cpu")
            assert math.isfinite(rate) and rate > 0
            assert {0, 1, 2} <= set(markers)
            assert "VRL_DECODE_CACHE_MB" not in os.environ


def test_profile_step_on_cpu(tmp_path, capsys):
    from video_rep_learning_tpu_torch.tools import profile_step

    profile_step.main(["carl", "--device", "cpu", "--steps", "1",
                       "--out", str(tmp_path / "trace")])
    out = capsys.readouterr().out
    assert "carl:" in out and "ms/step" in out and "clips/s" in out
    assert "device busy: not measured" in out
    rows = [line for line in out.splitlines() if "ms/step  x" in line]
    assert 10 <= len(rows) <= 40
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_profile_carl_budget_on_cpu(capsys):
    from video_rep_learning_tpu_torch.tools import profile_carl_budget

    times = profile_carl_budget.main(["--device", "cpu", "--iters", "1"])
    out = capsys.readouterr().out
    assert list(times) == list(profile_carl_budget.RUNGS)
    assert all(d is None and h > 0 for d, h in times.values())
    for rung in profile_carl_budget.RUNGS:
        assert f"\n{rung} " in out
    assert "TOTAL (full step)" in out and "not measured" in out


def test_sweep_frames_per_batch_on_cpu(capsys):
    from video_rep_learning_tpu_torch.tools import sweep_frames_per_batch

    res = sweep_frames_per_batch.main(["4", "--steps", "1", "--reps", "1",
                                       "--device", "cpu"])
    assert "FPB=4: mean" in capsys.readouterr().out
    assert len(res[4]) == 1 and res[4][0] > 0


# -- the synthetic-data maker --------------------------------------------------

SYNTH_CASES = [("pouring", "npy"), ("pouring", "mp4"), ("penn_action", "npy"),
               ("penn_action", "mp4"), ("kinetics400", "mp4")]


SYNTH_ARGS = ["--num_train", "3", "--num_val", "2", "--min_len", "8", "--max_len", "12",
              "--size", "64", "--seed", "3", "--num_actions", "2"]
# each package's maker over every case in a fresh process: the native H.264
# encoder's output depends on the process's floating-point state, which a
# torch CPU step earlier in the same process changes
MAKERS = {"port": "from video_rep_learning_tpu_torch.data.synthetic import main",
          "tool": "import runpy; main = runpy.run_path('tools/make_synthetic_data.py', "
                  "run_name='maker')['main']"}


@pytest.fixture(scope="module")
def synth_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    for who, load in MAKERS.items():
        calls = "".join(
            f"main(['--out', {str(root / who / f'{d}_{f}')!r}, '--dataset', {d!r}, "
            f"'--format', {f!r}] + {SYNTH_ARGS!r})\n" for d, f in SYNTH_CASES)
        subprocess.run([sys.executable, "-c", f"{load}\n{calls}"], check=True, cwd=REPO,
                       stdout=subprocess.DEVNULL)
    return root


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _frames(path, reader):
    r = reader(path)
    try:
        return r.read_all()
    finally:
        r.close()


@pytest.mark.parametrize("dataset, fmt", SYNTH_CASES)
def test_synthetic_sets_match_the_tool(synth_sets, dataset, fmt):
    from video_rep_learning_tpu.data import decode as jax_decode

    port, tool = synth_sets / "port" / f"{dataset}_{fmt}", synth_sets / "tool" / f"{dataset}_{fmt}"
    files = _tree(port)
    assert files == _tree(tool) and files
    for rel in files:
        if rel.endswith(".pkl"):
            with open(port / rel, "rb") as f:
                got = pickle.load(f)
            with open(tool / rel, "rb") as f:
                want = pickle.load(f)
            if dataset == "penn_action":
                assert got[1] == want[1]
                got, want = got[0], want[0]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif rel.endswith(".csv"):
            assert (port / rel).read_text() == (tool / rel).read_text()
        else:
            np.testing.assert_array_equal(
                _frames(str(port / rel), port_decode.VideoReader),
                _frames(str(tool / rel), jax_decode.VideoReader), err_msg=rel)


def test_make_pouring_keeps_its_npy_layout(tmp_path):
    train, val = synthetic.make_pouring(str(tmp_path), num_train=2, num_val=1,
                                        min_len=6, max_len=8, size=40, seed=1)
    assert [e["video_file"] for e in train] == ["videos/train_train_0.npy",
                                                "videos/train_train_1.npy"]
    assert np.load(tmp_path / val[0]["video_file"]).shape == (val[0]["seq_len"], 40, 40, 3)
    with pytest.raises(ValueError):
        synthetic.make_dataset(str(tmp_path / "x"), "pouring", "avi")
