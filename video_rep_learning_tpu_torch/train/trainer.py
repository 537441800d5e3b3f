"""The training loop.

Counterpart of `video_rep_learning_tpu/train/trainer.py` (`Trainer` with
`init_state`, `train_one_epoch`, `val_one_epoch`, `fit`): per step, the
uint8 clips go to the device, are augmented there (SSL: two views,
`ops/augment.py`: the crop+photometric kernel under USE_AMP, else the matmul
crop and the photometric kernel; otherwise the supervised recipe on one clip,
`supervised_batch_augment`, in val too, as the JAX val step), run through
the model in train mode, the algorithm's loss (SCL, TCC, TCN or
classification), the backward (the encoder's attention backward is the
flash backward kernel), global-norm clip, the optimizer and the per-epoch
LR. Classification's val "loss" is its masked accuracy.
Reference parity targets: `train.py:57-228`, the marker telemetry (marker 0 =
data wait, 1 = H2D, 2 = step dispatch, 5 = logging).

- Every random value of a step comes from a seed made of (RNG_SEED, stream,
  epoch, iteration): stream 0 the train augmentation (drawn on the host),
  1 the val augmentation, 2 dropout (through `torch.manual_seed`). A resumed
  run draws what an uninterrupted one would.
- Losses stay on the device and are read once per epoch; the one exception
  is the REPORT_INTERVAL log line.
- Under USE_AMP the backbone runs in bf16 (autocast for a ResNet, the bf16
  weight copy for a ViT); parameters, the head and the loss stay fp32 (bf16
  has fp32's range, so no gradient scaling).
- MV-Former (`configs_mvf/`) trains the same way. A fully frozen ViT runs
  forward only, in chunks, and every `backbone.*` tensor stays as loaded.
  A partially frozen one (MODEL.BASE_MODEL.LAYER below the depth) runs its
  front the same way and trains the back end (`res_finetune.*`: blocks
  LAYER.. and the final norm) on every frame of the step, its kernels'
  backward the plain composition chunked over FRAMES_PER_BATCH frames,
  recomputed under MODEL.REMAT. TRAIN.BACKBONE_WARMUP (smart fusion only)
  stops the head's gradient at the backbone's features for its first
  epochs.
- The SCL loss goes through `algos/scl.py::scl_loss_dispatch`: the fused
  CUDA kernels under VRL_FUSED_SCL=1, or at N >= 8192 frames by default.
- CHECKPOINT.SAVE_EVERY_N_ITERS n > 0 writes a mid-epoch checkpoint every
  n steps. A run resumed from one consumes the loader up to its iteration
  without stepping; the per-step seeds, the epoch-seeded loader and the
  epoch-pure LR then make it equal to an uninterrupted run bit for bit.
- The val epoch logs its last batch's augmented views as video panels
  (`_log_val_video_panels`), in a single process only.
- Across processes (`parallel/`, a process group joined before the trainer
  is built; JAX `trainer.py:57-79`), each rank runs TRAIN.BATCH_SIZE clips
  of its own shard: the BatchNorms that run on batch statistics become
  global (`convert_sync_batchnorm`), and `DistributedDataParallel` wraps
  the model and averages the gradients before the optimizer clips them.
  The rank's augmentation values are its rows of a draw for the global
  batch (the same views as one process over that batch), its dropout seed
  has the rank folded in (rank 0 keeps the one-process seed), the logged
  losses are the ranks' means, and only rank 0 writes checkpoints,
  summaries and panels. With one process and no process group the model
  is not wrapped.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..algos import get_algo
from ..config import ConfigNode
from ..data import construct_dataloader, unnorm
from ..logging_utils import get_logger
from ..models import build_model, set_trainable
from ..models.layers import convert_sync_batchnorm
from ..models.weights import load_model_state
from ..ops.augment import (AugmentParams, SupervisedParams, sample_ssl_batch,
                           sample_supervised_batch, ssl_batch_augment,
                           supervised_batch_augment)
from ..parallel import (all_reduce_sum, check_parallel_config, synchronize,
                        world)
from .checkpoint import resume, save_checkpoint, save_mid_checkpoint
from .optimizer import Optimizer, learning_rate_for_epoch

logger = get_logger(__name__)

TRAIN_STREAM, VAL_STREAM, DROPOUT_STREAM = 0, 1, 2
BATCH_KEYS = ("video_masks", "seq_lens", "chosen_steps", "labels")


def step_seed(seed: int, stream: int, epoch: int, it: int, rank: int = 0) -> int:
    """A 63-bit seed for one step of one stream, independent across steps
    and ranks; rank 0's is the one-process seed."""
    entropy = [seed, stream, epoch, it] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


class Trainer:
    """Owns the model, algo, optimizer and loaders of one run."""

    def __init__(self, cfg: ConfigNode, summary_writer=None, no_eval: bool = False,
                 build_loaders: bool = True, device="cuda"):
        check_parallel_config(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.world, self.rank = world()
        torch.manual_seed(cfg.RNG_SEED)  # the initial weights
        self.model = build_model(cfg, self.device)
        if cfg.MODEL.PRETRAINED_CHECKPOINT:
            self._warm_start(str(cfg.MODEL.PRETRAINED_CHECKPOINT))
        distributed = torch.distributed.is_initialized()
        if distributed:
            convert_sync_batchnorm(self.model)
        self.algo = get_algo(cfg)
        self.optimizer = Optimizer(
            set_trainable(self.model, cfg.MODEL.TRAIN_BASE,
                          classifier=cfg.TRAINING_ALGO == "classification"), cfg)
        # the train step's forward; DDP averages the gradients in the
        # backward. A trainable tensor may get no gradient on a step (the
        # tail behind TRAIN.BACKBONE_WARMUP's stopped gradient): DDP looks
        # for those each step and leaves their gradient None, as one
        # process does (`train.py:285-286` passes the same flag).
        self.net = self.model
        if distributed:
            self.net = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda"
                else None, broadcast_buffers=False, find_unused_parameters=True)
        self.summary_writer = summary_writer
        self.no_eval = no_eval
        self.train_loader = self.train_emb_loader = None
        self.val_loader = self.val_emb_loader = None
        if build_loaders:
            self.train_loader, self.train_emb_loader = construct_dataloader(
                cfg, "train", no_eval=no_eval)
            if not no_eval:
                self.val_loader, self.val_emb_loader = construct_dataloader(cfg, "val")
        if cfg.SSL:
            self.aug = AugmentParams(image_size=cfg.IMAGE_SIZE,
                                     strength=cfg.AUGMENTATION.STRENGTH,
                                     use_amp=bool(cfg.USE_AMP))
        else:
            self.aug = SupervisedParams.from_cfg(cfg)
        self.start_epoch = 0
        self.start_iter = 0  # > 0 after a resume from a mid-epoch checkpoint
        self.last_markers: Dict[int, float] = {}

    def _warm_start(self, path: str):
        """Weights-only warm start from a reference-layout `.pth`
        (`models/__init__.py:50-59`); the optimizer starts fresh."""
        if not path.endswith(".pth"):
            raise NotImplementedError(
                "MODEL.PRETRAINED_CHECKPOINT: the port reads reference-layout "
                f".pth files, not {path}")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        load_model_state(self.model, ckpt.get("model_state", ckpt))
        logger.info("warm start from torch checkpoint %s", path)

    def init_state(self, resume_mid: bool = True) -> int:
        """Auto-resume from the checkpoint of LOGDIR that is furthest along
        (epoch checkpoints only with `resume_mid=False`); returns the epoch
        to start at, and sets the iteration (`start_iter`)."""
        start = resume(self.cfg.LOGDIR, self.model, self.optimizer,
                       include_mid=resume_mid)
        self.start_epoch, self.start_iter = (0, 0) if start is None else start
        return self.start_epoch

    # -- one step ---------------------------------------------------------

    def device_batch(self, batch):
        """The numpy batch's uint8 videos, (B, V, T, H, W, 3) under SSL else
        (B, T, H, W, 3), and its per-frame arrays (BATCH_KEYS that it has) on
        the device (the clip's true dims stay on the host for the box
        sampling)."""
        dev = {"videos": torch.as_tensor(np.ascontiguousarray(batch["videos"])
                                         ).to(self.device, non_blocking=True)}
        for k in BATCH_KEYS:
            if k in batch:
                dev[k] = torch.as_tensor(np.asarray(batch[k])).to(self.device)
        return dev

    def augment(self, batch, dev_batch, stream: int, epoch: int, it: int):
        """The step's augmentation, its random values drawn from the step's
        generator: two SSL views a clip, or the supervised recipe. Rank r
        takes its rows of a draw for the global batch (the lower ranks'
        clips are drawn and dropped)."""
        videos = dev_batch["videos"]
        gen = torch.Generator().manual_seed(
            step_seed(self.cfg.RNG_SEED, stream, epoch, it))
        B = videos.shape[0]
        if self.cfg.SSL:
            _, V, _, H, W, _ = videos.shape
            sampled = sample_ssl_batch(gen, B, V, H, W, batch.get("dims"), self.aug,
                                       skip=self.rank * B)
            return ssl_batch_augment(videos, sampled, self.aug)
        _, _, H, W, _ = videos.shape
        sampled = sample_supervised_batch(gen, B, H, W, batch.get("dims"), self.aug,
                                          skip=self.rank * B)
        return supervised_batch_augment(videos, sampled, self.aug)

    def backbone_warmup_active(self, epoch: int) -> bool:
        """TRAIN.BACKBONE_WARMUP: epochs before it keep the backbone out of
        the gradient (`train.py:81-85`); it needs smart fusion."""
        warmup = self.cfg.TRAIN.BACKBONE_WARMUP
        if warmup is None:
            return False
        if self.cfg.MODEL.EMBEDDER_MODEL.FUSION_TYPE != "smart":
            raise ValueError("BACKBONE_WARMUP requires smart fusion "
                             "(`train.py:81-85`)")
        return epoch < warmup

    def train_step(self, batch, dev_batch, epoch: int, it: int, lr: float,
                   warmup_active: bool = False):
        """One optimizer step; returns the loss as a device scalar with NaN
        zeroed."""
        self.model.train()
        videos = self.augment(batch, dev_batch, TRAIN_STREAM, epoch, it)
        torch.manual_seed(step_seed(self.cfg.RNG_SEED, DROPOUT_STREAM, epoch, it,
                                    self.rank))
        loss = self.algo.compute_loss(self.net, dict(dev_batch, videos=videos),
                                      backbone_warmup_active=warmup_active)["loss"]
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step(lr)
        loss = loss.detach()
        return torch.where(torch.isnan(loss), 0.0, loss)

    # -- epochs -----------------------------------------------------------

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        warmup_active = self.backbone_warmup_active(epoch)
        self.train_loader.set_epoch(epoch)
        lr = learning_rate_for_epoch(cfg, epoch)
        # a mid-epoch resume consumes the loader up to the saved iteration
        # without stepping
        skip_until = self.start_iter if epoch == self.start_epoch else 0
        self.start_iter = 0
        save_n = int(cfg.CHECKPOINT.SAVE_EVERY_N_ITERS or 0)
        data_size = len(self.train_loader)
        losses = []
        tmt = {i: 0.0 for i in range(10)}
        tmc = 0
        t1 = time.time()
        for cur_iter, batch in enumerate(self.train_loader):
            if cur_iter < skip_until:
                t1 = time.time()
                continue
            tmc += 1
            tmt[0] += time.time() - t1
            t1 = time.time()
            dev_batch = self.device_batch(batch)
            tmt[1] += time.time() - t1
            t1 = time.time()
            losses.append(self.train_step(batch, dev_batch, epoch, cur_iter, lr,
                                          warmup_active))
            tmt[2] += time.time() - t1
            t1 = time.time()
            if cur_iter % cfg.LOGGING.REPORT_INTERVAL == 0:
                # reading the value waits for this step
                logger.info("iter %d, training loss: %.3f", data_size * epoch + cur_iter,
                            self._rank_mean(float(losses[-1])))
            if save_n > 0 and (cur_iter + 1) % save_n == 0:
                save_mid_checkpoint(cfg.LOGDIR, self.model, self.optimizer, epoch,
                                    cur_iter + 1, cfg)
            tmt[5] += time.time() - t1
            t1 = time.time()

        total = float(torch.stack(losses).sum().cpu()) / data_size if losses else 0.0
        total = self._rank_mean(total)
        # per-iteration marker means; marker 2 is step dispatch (the device
        # finishes the steps by the read above)
        self.last_markers = {i: tmt[i] / max(tmc, 1) for i in range(10)
                             if tmt[i] > 0.0}
        for i, v in self.last_markers.items():
            print("marker %i: %f" % (i, v))
        print("loops: %i" % tmc)
        if self.summary_writer is not None:
            self.summary_writer.add_scalar("train/learning_rate", lr, epoch)
            self.summary_writer.add_scalar("train/loss", total, epoch)
        logger.info("epoch %d, train loss: %.3f", epoch, total)
        return {"loss": total}

    @torch.no_grad()
    def val_one_epoch(self, epoch: int) -> Dict[str, float]:
        """The loss over the val loader with running BN statistics and no
        dropout (`train=False` in the JAX package); for classification the
        masked accuracy."""
        self.model.eval()
        data_size = len(self.val_loader)
        losses = []
        videos = names = None
        for cur_iter, batch in enumerate(self.val_loader):
            dev_batch = self.device_batch(batch)
            videos = self.augment(batch, dev_batch, VAL_STREAM, 0, cur_iter)
            names = batch.get("names")
            loss = self.algo.compute_loss(self.model,
                                          dict(dev_batch, videos=videos))["loss"]
            losses.append(torch.where(torch.isnan(loss), 0.0, loss))
        total = float(torch.stack(losses).sum().cpu()) / data_size if losses else 0.0
        total = self._rank_mean(total)
        self._log_val_video_panels(videos, names)
        if self.summary_writer is not None:
            self.summary_writer.add_scalar("val/loss", total, epoch)
        logger.info("epoch %d, val loss: %.3f", epoch, total)
        return {"loss": total}

    def _rank_mean(self, value: float) -> float:
        """A host value's mean over the ranks (the JAX package's loss is
        the global batch's)."""
        return all_reduce_sum(value) / self.world if self.world > 1 else value

    def _log_val_video_panels(self, videos, names):
        """Video panels of the last val batch's augmented views
        (`train.py:217-224`): its first clip, every second frame,
        unnormalised, at 4 fps; one panel a view under SSL. A single process
        only, as in the reference."""
        if self.summary_writer is None or videos is None or self.world != 1:
            return
        # fp32 at the host boundary: under USE_AMP the frames are bf16
        item = videos[0].float().cpu().numpy()  # (V, T, S, S, 3) | (T, S, S, 3)
        tag = f"{tuple(names)}" if names is not None else "val_batch"
        if self.cfg.SSL:
            for i, view in enumerate(item):
                arr = unnorm(view[::2].transpose(0, 3, 1, 2))
                self.summary_writer.add_video(f"{tag}_view{i}", arr[None], 0, fps=4)
        else:
            arr = unnorm(item[::2].transpose(0, 3, 1, 2))
            self.summary_writer.add_video(tag, arr[None], 0, fps=4)

    def fit(self, evaluate_fn=None):
        """`train.py:309-339`: epochs from `start_epoch`, a checkpoint every
        SAVE_INTERVAL epochs and after the last, the val loss and
        `evaluate_fn(trainer, epoch)` every VAL_INTERVAL epochs and after the
        last."""
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.TRAIN.MAX_EPOCHS):
            logger.info("Training epoch %d/%d, %d iters each epoch",
                        epoch, cfg.TRAIN.MAX_EPOCHS, len(self.train_loader))
            t0 = time.time()
            self.train_one_epoch(epoch)
            print("train done in (m): " + str((time.time() - t0) / 60.0))
            last = epoch == cfg.TRAIN.MAX_EPOCHS - 1
            if (epoch + 1) % cfg.CHECKPOINT.SAVE_INTERVAL == 0 or last:
                save_checkpoint(cfg.LOGDIR, self.model, self.optimizer, epoch, cfg)
            if not self.no_eval and ((epoch + 1) % cfg.EVAL.VAL_INTERVAL == 0
                                     or last):
                self.val_one_epoch(epoch)
                if evaluate_fn is not None:
                    t0 = time.time()
                    evaluate_fn(self, epoch)
                    print("evaluate_once done in (m): "
                          + str((time.time() - t0) / 60.0))
