"""Mid-epoch checkpoints with exact resume, and the val video panels, in the
port's trainer (the JAX package's `train/checkpoint.py:60-117` and
`train/trainer.py:386-433, 478-508`).

- A micro CARL run (ResNet-50 with a trainable layer4 and its BN, 32 px, 6
  steps an epoch) with CHECKPOINT.SAVE_EVERY_N_ITERS 2, stopped after its
  second mid save and resumed by a new trainer, ends bit for bit where the
  uninterrupted run ends: every parameter, BN buffer and optimizer moment.
- Only the newest mid checkpoint is kept, an epoch save removes them all,
  and a resume starts from whichever checkpoint is furthest along.
- The evaluation CLI's loader reads epoch checkpoints only.
- The val epoch writes one video panel a view under SSL and one under
  supervised training.
"""

import os

import numpy as np
import pytest
import torch

from video_rep_learning_tpu_torch.models import load_checkpoint
from video_rep_learning_tpu_torch.train import Optimizer, Trainer
from video_rep_learning_tpu_torch.train import checkpoint as ckpt
from video_rep_learning_tpu_torch.train import trainer as trainer_mod

from tests.test_torch_model import small_carl_cfg

torch.set_num_threads(1)

STEPS, SAVE_N = 6, 2


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    root = tmp_path_factory.mktemp("mid_ckpt")
    make_pouring(str(root / "pouring"), num_train=STEPS, num_val=2, min_len=12,
                 max_len=16, size=40, seed=0)
    return root


def _cfg(root, logdir):
    cfg = small_carl_cfg()
    cfg.PATH_TO_DATASET = str(root / "pouring")
    cfg.LOGDIR = logdir
    cfg.TRAIN.NUM_FRAMES = 4
    cfg.TRAIN.MAX_EPOCHS = 1
    cfg.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 8
    cfg.MODEL.EMBEDDER_MODEL.NUM_LAYERS = 1
    cfg.CHECKPOINT.SAVE_EVERY_N_ITERS = SAVE_N
    cfg.DATA.NUM_WORKERS = 0
    cfg.USE_AMP = False
    cfg.EVAL.BATCH_SIZE = 1
    return cfg


class _Preempted(Exception):
    pass


def _listing(logdir):
    return sorted(os.listdir(os.path.join(logdir, "checkpoints")))


def test_preempted_run_resumes_bit_for_bit(synth, tmp_path, monkeypatch):
    once_dir, cut_dir = str(tmp_path / "once"), str(tmp_path / "cut")
    saved = []
    real_save = ckpt.save_mid_checkpoint

    def save_and_list(logdir, model, optimizer, epoch, next_iter, cfg=None):
        path = real_save(logdir, model, optimizer, epoch, next_iter, cfg)
        saved.append((next_iter, _listing(logdir)))
        if logdir == cut_dir and next_iter == 2 * SAVE_N:
            raise _Preempted
        return path

    monkeypatch.setattr(trainer_mod, "save_mid_checkpoint", save_and_list)

    once = Trainer(_cfg(synth, once_dir), no_eval=True, device="cpu")
    assert len(once.train_loader) == STEPS and once.init_state() == 0
    once.fit()
    # every save keeps only itself; the epoch save removes the last one
    assert saved == [(i, [f"checkpoint_iter_00000_{i:07d}.pth"])
                     for i in range(SAVE_N, STEPS + 1, SAVE_N)]
    assert _listing(once_dir) == ["checkpoint_epoch_00000.pth"]

    cut = Trainer(_cfg(synth, cut_dir), no_eval=True, device="cpu")
    cut.init_state()
    with pytest.raises(_Preempted):
        cut.fit()
    assert cut.optimizer.count == 2 * SAVE_N
    assert _listing(cut_dir) == [f"checkpoint_iter_00000_{2 * SAVE_N:07d}.pth"]

    resumed = Trainer(_cfg(synth, cut_dir), no_eval=True, device="cpu")
    assert resumed.init_state() == 0 and resumed.start_iter == 2 * SAVE_N
    assert resumed.optimizer.count == 2 * SAVE_N
    resumed.fit()
    assert resumed.optimizer.count == once.optimizer.count == STEPS
    assert _listing(cut_dir) == ["checkpoint_epoch_00000.pth"]

    want = once.model.state_dict()
    got = resumed.model.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("running_var") for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    for which in ("mu", "nu"):
        assert len(getattr(once.optimizer, which)) > 0
        for a, b in zip(getattr(once.optimizer, which), getattr(resumed.optimizer, which)):
            assert torch.equal(a, b), which


def _tiny():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    cfg = small_carl_cfg()
    return model, Optimizer(list(model.named_parameters()), cfg)


def _marked(model, value):
    with torch.no_grad():
        model[0].weight.fill_(value)
    return model


def test_furthest_checkpoint_wins(tmp_path):
    logdir = str(tmp_path)
    model, opt = _tiny()
    assert ckpt.resume(logdir, model, opt) is None
    ckpt.save_checkpoint(logdir, _marked(model, 1.0), opt, 0)
    ckpt.save_mid_checkpoint(logdir, _marked(model, 2.0), opt, 1, 3)
    assert ckpt.resume(logdir, _marked(model, 0.0), opt) == (1, 3)
    assert float(model[0].weight[0, 0].detach()) == 2.0
    assert ckpt.resume(logdir, model, opt, include_mid=False) == (1, 0)
    assert float(model[0].weight[0, 0].detach()) == 1.0
    ckpt.save_mid_checkpoint(logdir, _marked(model, 3.0), opt, 1, 5)
    assert _listing(logdir) == ["checkpoint_epoch_00000.pth",
                                "checkpoint_iter_00001_0000005.pth"]
    ckpt.save_checkpoint(logdir, _marked(model, 4.0), opt, 1)
    assert _listing(logdir) == ["checkpoint_epoch_00000.pth",
                                "checkpoint_epoch_00001.pth"]
    # an older mid checkpoint loses to the epoch checkpoint past it
    ckpt.save_mid_checkpoint(logdir, _marked(model, 5.0), opt, 1, 7)
    assert ckpt.resume(logdir, model, opt) == (2, 0)
    assert float(model[0].weight[0, 0].detach()) == 4.0


def test_eval_loader_ignores_mid_checkpoints(tmp_path):
    logdir = str(tmp_path)
    model, opt = _tiny()
    ckpt.save_mid_checkpoint(logdir, _marked(model, 2.0), opt, 0, 4)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(model, logdir)
    ckpt.save_checkpoint(logdir, _marked(model, 1.0), opt, 0)
    ckpt.save_mid_checkpoint(logdir, _marked(model, 3.0), opt, 1, 2)
    assert load_checkpoint(_marked(model, 0.0), logdir) == 0
    assert float(model[0].weight[0, 0].detach()) == 1.0


class _Panels:
    def __init__(self):
        self.videos = []

    def add_video(self, tag, video, step, fps=4):
        self.videos.append((tag, np.asarray(video), step, fps))

    def add_scalar(self, *args):
        pass


@pytest.mark.parametrize("ssl", [True, False])
def test_val_video_panels(synth, tmp_path, ssl):
    cfg = _cfg(synth, str(tmp_path))
    if not ssl:
        cfg.SSL = False
        cfg.TRAINING_ALGO = "classification"
    writer = _Panels()
    tr = Trainer(cfg, summary_writer=writer, device="cpu")
    tr.val_one_epoch(0)
    S, T = cfg.IMAGE_SIZE, cfg.TRAIN.NUM_FRAMES
    assert len(writer.videos) == (2 if ssl else 1)
    for i, (tag, video, step, fps) in enumerate(writer.videos):
        assert tag.endswith(f"_view{i}") == ssl and tag.startswith("(")
        assert video.shape == (1, -(-T // 2), 3, S, S) and step == 0 and fps == 4
        assert video.min() >= 0.0 and video.max() <= 1.0 and video.std() > 0
