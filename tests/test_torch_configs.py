"""Every shipped configuration (`configs/*.yml`, `configs_mvf/*.yml`) in the
port: each resolves a model spec and an algorithm and builds its model
(`NOT_YET`, the configurations that would raise NotImplementedError naming
the ROADMAP queue 1 item that brings them, is empty). The ten
configurations of the TCC / TCN / classification slice and the conv SCL
ones, and the three late-fusion ViT ablations (`ablate_dinoB8_*`, on a
test-only 2-block ViT), train one step on the CPU, shrunk to test size (32
px, 4 frames a clip, narrow heads) on a batch as the loader lays it out."""

import glob
import os

import numpy as np
import pytest
import torch

from video_rep_learning_tpu_torch.algos import get_algo
from video_rep_learning_tpu_torch.config import get_cfg, load_yaml_into
from video_rep_learning_tpu_torch.models import CARLModel, resolve_model_spec
from video_rep_learning_tpu_torch.models import vit
from video_rep_learning_tpu_torch.train import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for d in ("configs", "configs_mvf")
                 for p in glob.glob(os.path.join(REPO, d, "*.yml")))
# the configurations the port cannot build yet, and the item that brings them
NOT_YET = {}
LATE_VIT = [f"configs_mvf/ablate_dinoB8_{k}.yml" for k in ("avg", "cls", "max")]
SUPERVISED = ["configs/tcc_transformer_config.yml", "configs/tcc_config.yml",
              "configs/tcc_action_config.yml", "configs/tcc_finegym_config.yml",
              "configs/tcn_config.yml",
              "configs/classification_transformer_config.yml",
              "configs/classification_transformer_finegym_config.yml",
              "configs/scl_config.yml", "configs/scl_action_config.yml",
              "configs/scl_finegym_config.yml"]


def _load(path):
    cfg = get_cfg()
    load_yaml_into(cfg, os.path.join(REPO, path))
    return cfg


def test_every_config_is_listed():
    assert len(CONFIGS) == 34
    assert set(NOT_YET) | set(SUPERVISED) | set(LATE_VIT) <= set(CONFIGS)
    assert not NOT_YET


@pytest.mark.parametrize("path", CONFIGS)
def test_config_resolves_or_names_its_item(path):
    cfg = _load(path)
    if path in NOT_YET:
        with pytest.raises(NotImplementedError, match=NOT_YET[path]):
            resolve_model_spec(cfg)
        return
    spec = resolve_model_spec(cfg)
    algo = get_algo(cfg)
    assert type(algo).__name__.lower() == cfg.TRAINING_ALGO
    assert spec.num_contexts == cfg.DATA.NUM_CONTEXTS
    with torch.device("meta"):  # the module tree at full width, no memory
        model = CARLModel(spec)
    assert sum(p.numel() for p in model.parameters()) > 0


def _shrink(cfg):
    cfg.IMAGE_SIZE = 32
    cfg.TRAIN.NUM_FRAMES = 4
    cfg.TRAIN.BATCH_SIZE = 2
    e = cfg.MODEL.EMBEDDER_MODEL
    e.CONV_LAYERS = [[8, 1, 0]]  # the layer3 grid is 2x2 at 32 px
    e.FC_LAYERS = [[16, True]]
    e.CAPACITY_SCALAR = 1
    e.NUM_LAYERS, e.HIDDEN_SIZE, e.D_FF, e.NUM_HEADS = 1, 16, 32, 2
    e.EMBEDDING_SIZE = 8
    cfg.MODEL.PROJECTION_SIZE = 16
    return cfg


def _batch(cfg, rng):
    """A numpy batch as the loader gives it: (B, T * ctx, H, W, 3) uint8
    clips, or (B, 2, T, ...) two views under SSL, with per-frame masks,
    steps and labels and each clip's true dims."""
    B, T, ctx = cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_FRAMES, cfg.DATA.NUM_CONTEXTS
    lead = (B, 2) if cfg.SSL else (B,)
    return {"videos": rng.randint(0, 256, lead + (T * ctx, 40, 40, 3)).astype(np.uint8),
            "video_masks": np.ones(lead + (T,), np.float32),
            "seq_lens": np.full(lead, 50, np.int32),
            "chosen_steps": np.sort(rng.randint(0, 50, lead + (T,)), -1).astype(np.int32),
            "labels": rng.randint(0, 3, lead + (T,)).astype(np.int32),
            "dims": np.tile(np.array([40, 36], np.float32), (B, 1))}


@pytest.mark.parametrize("path", SUPERVISED)
def test_config_trains_a_step(path):
    cfg = _shrink(_load(path))
    tr = Trainer(cfg, build_loaders=False, device="cpu")
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()
              if p.requires_grad}
    batch = _batch(cfg, np.random.RandomState(0))
    loss = float(tr.train_step(batch, tr.device_batch(batch), 0, 0, 1e-3))
    assert np.isfinite(loss) and loss != 0.0
    assert any(not torch.equal(p, before[n]) for n, p in tr.model.named_parameters()
               if n in before)


@pytest.fixture(scope="module")
def tiny_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit.VIT_SPECS, "vit_configs_test", vit.ViTSpec(32, 2, 2, 8, img_size=32))
        yield "TIMM-vit_configs_test"


@pytest.mark.parametrize("path", LATE_VIT)
def test_late_vit_config_trains_a_step(path, tiny_vit):
    """The three late-fusion ViT ablations, their ViT-B/8 swapped for a
    2-block test ViT (taps 0 and 1 for the spatial ones)."""
    cfg = _shrink(_load(path))
    cfg.MODEL.BASE_MODEL.NETWORK = tiny_vit
    cfg.MODEL.EMBEDDER_MODEL.SMART_FEATS = "0,1"
    tr = Trainer(cfg, build_loaders=False, device="cpu")
    assert tr.model.spec.fusion_type == "late"
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    batch = _batch(cfg, np.random.RandomState(0))
    loss = float(tr.train_step(batch, tr.device_batch(batch), 0, 0, 1e-3))
    assert np.isfinite(loss) and loss != 0.0
    moved = {n for n, p in tr.model.named_parameters() if not torch.equal(p, before[n])}
    assert moved and not any(n.startswith("backbone.") for n in moved)


@pytest.mark.parametrize("sequence", [False, True])
def test_tensor_parallelism_names_its_item(sequence):
    """Every shipped config runs data parallelism (PARALLEL.TENSOR_PARALLELISM
    1); the JAX package's head-parallel and Ulysses layouts beyond the
    reference raise where the trainer reads the config, naming item 6b."""
    assert all(int(_load(p).PARALLEL.TENSOR_PARALLELISM) == 1 for p in CONFIGS)
    cfg = _shrink(_load("configs/scl_transformer_config.yml"))
    cfg.PARALLEL.TENSOR_PARALLELISM = 2
    cfg.PARALLEL.SEQUENCE_PARALLELISM = sequence
    match = "Ulysses" if sequence else "queue 1 item 6b"
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, build_loaders=False, device="cpu")
