"""The trainer's device prefetch (`train/prefetch.py`, DATA.DEVICE_PREFETCH),
the counterpart of the JAX package's `_batch_stream`, on the CPU: there the
worker thread and its queue run as on a card, without streams or pinning.

- A micro CARL run (ResNet-50 with a trainable layer4, 32 px, 6 steps an
  epoch) at depth 0 and at depth 2: the same loss and every parameter, BN
  buffer and optimizer moment bit for bit, with the steps running beside
  the `h2d-prefetch` thread only at depth 2.
- At depth 2 a run stopped after its second mid-epoch save and resumed
  ends bit for bit where the uninterrupted run ends, and the resumed epoch
  copies only the batches it steps on.
- A loader that raises surfaces its exception in the consumer; a `break`,
  an exception or a KeyboardInterrupt in the step leave no live `h2d`
  thread.
- The markers: at depth 0 the reference's serial ones (marker 1 the copy
  inside the loop), at depth 2 marker 0 the whole wait for a batch and
  marker 1 the copy's time on the worker.
"""

import threading
import time
from contextlib import closing

import numpy as np
import pytest
import torch

from video_rep_learning_tpu_torch.config import get_cfg
from video_rep_learning_tpu_torch.train import Trainer
from video_rep_learning_tpu_torch.train import checkpoint as ckpt
from video_rep_learning_tpu_torch.train import trainer as trainer_mod
from video_rep_learning_tpu_torch.train.prefetch import THREAD_NAME, DevicePrefetcher

torch.set_num_threads(1)

STEPS, SAVE_N = 6, 2


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    root = tmp_path_factory.mktemp("prefetch")
    make_pouring(str(root / "pouring"), num_train=STEPS, num_val=2, min_len=12,
                 max_len=16, size=40, seed=0)
    return root


def _cfg(root, logdir, depth, save_n=0):
    cfg = get_cfg()
    cfg.PATH_TO_DATASET = str(root / "pouring")
    cfg.LOGDIR = logdir
    cfg.IMAGE_SIZE = 32
    cfg.TRAIN.NUM_FRAMES = 4
    cfg.TRAIN.MAX_EPOCHS = 1
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 8
    e = cfg.MODEL.EMBEDDER_MODEL
    e.NUM_LAYERS, e.FC_LAYERS, e.CAPACITY_SCALAR = 1, [[32, True]], 1
    e.HIDDEN_SIZE, e.NUM_HEADS, e.D_FF, e.EMBEDDING_SIZE = 64, 2, 64, 16
    cfg.MODEL.PROJECTION_SIZE = 24
    cfg.CHECKPOINT.SAVE_EVERY_N_ITERS = save_n
    cfg.DATA.NUM_WORKERS = 0
    cfg.DATA.DEVICE_PREFETCH = depth
    cfg.USE_AMP = False
    return cfg


def h2d_threads():
    return [t for t in threading.enumerate() if t.name == THREAD_NAME and t.is_alive()]


def _assert_same_state(a, b):
    want, got = a.model.state_dict(), b.model.state_dict()
    assert set(got) == set(want) and any(k.endswith("running_var") for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    for which in ("mu", "nu"):
        assert len(getattr(a.optimizer, which)) > 0
        for x, y in zip(getattr(a.optimizer, which), getattr(b.optimizer, which)):
            assert torch.equal(x, y), which


_RUNS = {}


def run(synth, tmp_path_factory, depth):
    """One uninterrupted epoch at `depth`: (trainer, loss, which threads ran
    beside each step), once a module."""
    if depth not in _RUNS:
        tr = Trainer(_cfg(synth, str(tmp_path_factory.mktemp(f"d{depth}")), depth),
                     no_eval=True, device="cpu")
        tr.init_state()
        beside = []
        step = tr.train_step

        def spy(*args, **kwargs):
            beside.append(len(h2d_threads()))
            return step(*args, **kwargs)

        tr.train_step = spy
        loss = tr.train_one_epoch(0)["loss"]
        _RUNS[depth] = (tr, loss, beside)
    return _RUNS[depth]


def test_depth_2_matches_depth_0_bit_for_bit(synth, tmp_path_factory):
    serial, serial_loss, serial_beside = run(synth, tmp_path_factory, 0)
    ahead, ahead_loss, ahead_beside = run(synth, tmp_path_factory, 2)
    assert serial.prefetcher is None and ahead.prefetcher.depth == 2
    # the worker ends once its last batch and the end mark are queued (two
    # deep): it is alive beside every step before then
    assert serial_beside == [0] * STEPS and ahead_beside[:STEPS - 2] == [1] * (STEPS - 2)
    assert np.isfinite(serial_loss) and ahead_loss == serial_loss
    assert serial.optimizer.count == ahead.optimizer.count == STEPS
    _assert_same_state(serial, ahead)
    assert not h2d_threads()


class _Preempted(Exception):
    pass


def test_mid_epoch_resume_at_depth_2_bit_for_bit(synth, tmp_path, tmp_path_factory,
                                                 monkeypatch):
    once = run(synth, tmp_path_factory, 2)[0]
    cut_dir = str(tmp_path / "cut")
    real_save = ckpt.save_mid_checkpoint

    def save(logdir, model, optimizer, epoch, next_iter, cfg=None):
        path = real_save(logdir, model, optimizer, epoch, next_iter, cfg)
        if next_iter == 2 * SAVE_N:
            raise _Preempted
        return path

    monkeypatch.setattr(trainer_mod, "save_mid_checkpoint", save)
    cut = Trainer(_cfg(synth, cut_dir, 2, SAVE_N), no_eval=True, device="cpu")
    cut.init_state()
    with pytest.raises(_Preempted):
        cut.fit()
    assert cut.optimizer.count == 2 * SAVE_N and not h2d_threads()

    copied = []
    real_copy = Trainer.device_batch
    monkeypatch.setattr(Trainer, "device_batch",
                        lambda self, batch: copied.append(1) or real_copy(self, batch))
    resumed = Trainer(_cfg(synth, cut_dir, 2, SAVE_N), no_eval=True, device="cpu")
    assert resumed.init_state() == 0 and resumed.start_iter == 2 * SAVE_N
    resumed.fit()
    assert len(copied) == STEPS - 2 * SAVE_N  # the skipped batches: no copy
    assert resumed.optimizer.count == STEPS
    _assert_same_state(once, resumed)
    assert not h2d_threads()


# -- the stream's own behaviour, on a loader of small synthetic batches ------

class Loader:
    """`n` batches of the trainer's layout; raises at batch `fail_at`, and
    each batch takes `delay` seconds to make."""

    def __init__(self, n=8, fail_at=None, delay=0.0):
        self.n, self.fail_at, self.delay = n, fail_at, delay
        self.made = 0

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise RuntimeError(f"loader failed at batch {i}")
            time.sleep(self.delay)
            self.made += 1
            yield {"videos": np.full((1, 2, 2, 4, 4, 3), i, np.uint8),
                   "video_masks": np.ones((1, 2, 2), np.float32),
                   "dims": np.array([[4.0, 4.0]], np.float32), "names": [f"v{i}"]}


def prefetcher(depth=2):
    return DevicePrefetcher("cpu", depth, trainer_mod.BATCH_KEYS,
                            lambda b: {"videos": torch.as_tensor(b["videos"]),
                                       "video_masks": torch.as_tensor(b["video_masks"])})


def test_stream_order_and_skip():
    got = list(prefetcher().stream(Loader(), skip_until=3))
    assert [g[0] for g in got] == list(range(8))
    for it, host, dev, h2d_s in got:
        if it < 3:
            assert host is None and dev is None and h2d_s == 0.0
        else:
            assert "videos" not in host and host["names"] == [f"v{it}"]
            assert int(dev["videos"][0, 0, 0, 0, 0, 0]) == it and h2d_s >= 0.0
    assert not h2d_threads()


def test_loader_exception_surfaces_in_consumer():
    seen = []
    with pytest.raises(RuntimeError, match="loader failed at batch 3"):
        for it, *_ in prefetcher().stream(Loader(fail_at=3)):
            seen.append(it)
    assert seen == [0, 1, 2] and not h2d_threads()


def test_break_stops_and_joins_the_worker():
    loader = Loader(n=1000)
    with closing(prefetcher(depth=1).stream(loader)) as batches:
        for it, *_ in batches:
            assert h2d_threads()
            if it == 2:
                break
    assert not h2d_threads()
    assert loader.made < 10  # the worker stopped, it did not run the loader out


@pytest.mark.parametrize("error", [ValueError, KeyboardInterrupt])
def test_exception_in_the_step_joins_the_worker(error, monkeypatch):
    tr = Trainer(_cfg_fake(2), build_loaders=False, device="cpu")
    tr.train_loader = Loader(n=50)

    def step(batch, dev_batch, epoch, it, lr, warmup=False):
        if it == 3:
            raise error("step failed")
        return torch.zeros(())

    monkeypatch.setattr(tr, "train_step", step)
    with pytest.raises(error, match="step failed"):
        tr.train_one_epoch(0)
    assert not h2d_threads()


def _cfg_fake(depth):
    cfg = get_cfg()
    cfg.IMAGE_SIZE = 32
    cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS = 1
    cfg.DATA.DEVICE_PREFETCH = depth
    return cfg


@pytest.mark.parametrize("depth", [0, 2])
def test_markers(depth, monkeypatch, capsys):
    """Copies of 0.1 s and steps of 0.2 s: at depth 0 the copy is marker 1
    inside the loop (and not in the wait); at depth 2 it runs beside the
    steps, marker 1 reports it and marker 0, the wait, stays short."""
    copy_s, step_s = 0.1, 0.2
    real_copy = Trainer.device_batch

    def slow_copy(self, batch):
        time.sleep(copy_s)
        return real_copy(self, batch)

    monkeypatch.setattr(Trainer, "device_batch", slow_copy)
    tr = Trainer(_cfg_fake(depth), build_loaders=False, device="cpu")
    tr.train_loader = Loader(n=6)
    monkeypatch.setattr(tr, "train_step", lambda *a, **k: time.sleep(step_s)
                        or torch.zeros(()))
    tr.train_one_epoch(0)
    m = tr.last_markers
    assert m[1] >= copy_s and m[2] >= step_s
    if depth == 0:
        assert m.get(0, 0.0) < copy_s  # the copy is not in the wait
    else:
        # only the first batch waits for its copy: (0.1 + 5 x ~0) / 6
        assert m[0] < copy_s * 0.6
    out = capsys.readouterr().out
    assert "loops: 6" in out and "marker 1:" in out
    assert not h2d_threads()


def test_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth 0"):
        prefetcher(depth=0)


@pytest.mark.timeout(300)
def test_two_ranks_epochs_at_depth_0_and_2_match(tmp_path, capsys, monkeypatch):
    """Each rank its own worker: `tools/ddp_cards.py --epochs 2` at two gloo
    ranks, the training loop at DATA.DEVICE_PREFETCH 0 and 2, ends on the
    same state bit for bit (the ranks agree after every epoch)."""
    import json

    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.tools import ddp_cards

    from tests.test_torch_parallel import REPO, SMALL_OPTS

    make_pouring(str(tmp_path / "pouring"), num_train=4, num_val=2, min_len=14,
                 max_len=20, size=40, seed=0)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runs = {}
    for depth in (0, 2):
        ddp_cards.main(["--workdir", str(tmp_path), "--cfg_file",
                        "configs/scl_transformer_config.yml", "--worlds", "2",
                        "--epochs", "2", "--device", "cpu", "--timeout", "240", "--opts",
                        *SMALL_OPTS, "DATA.DEVICE_PREFETCH", str(depth)])
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
        assert len(lines) == 1 and lines[0]["world"] == 2 and lines[0]["epochs"] == 2
        runs[depth] = lines[0]
    assert runs[0]["digest_rank0"] == runs[2]["digest_rank0"]
    assert runs[0]["losses_rank0"] == runs[2]["losses_rank0"]
