"""Typed, dot-accessible configuration tree for CARL / MV-Former.

The port's own copy of `video_rep_learning_tpu/config.py`: the same schema,
defaults and merge rules, so every shipped YAML loads unchanged in both
packages (the port imports nothing of the JAX package). Keys that only the
JAX package reads (REMAT, QUANTIZE_BACKBONE, PARALLEL, ...) stay in the
schema so a frozen `config.yml` written by either package loads in the other.

Schema-compatible with the reference config system
(the reference's `utils/config.py:6-247` and `utils/parser.py:46-87`):
every YAML file that loads against the reference loads unmodified here and
produces the same *effective* configuration.

Two intentional divergences from the reference (documented per SURVEY.md §7):

1. The reference overlays YAML with ``EasyDict.update`` which replaces whole
   top-level sub-trees (`utils/parser.py:74-78`); we deep-merge instead, so
   defaults inside a subtree survive a partial YAML override. The reference's
   shipped YAMLs fully specify their subtrees, so the effective configs are
   identical for all 34 shipped workloads.
2. The reference *presence-checks* many optional keys (e.g. ``'FUSION_TYPE' in
   cfg.MODEL.EMBEDDER_MODEL`` — `models/transformer.py:22-25`). We give every
   such key an explicit default equal to the reference's fallback behaviour, so
   presence checks become plain value reads. Keys whose mere presence *enables*
   a feature (e.g. ``TRAIN.BACKBONE_WARMUP``) default to ``None`` = disabled.
"""

from __future__ import annotations

import copy
import io
from typing import Any

import yaml


class ConfigNode(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, d: dict | None = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            return ConfigNode(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigNode._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, ConfigNode._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- helpers ----------------------------------------------------------

    def merge_from(self, other: dict) -> "ConfigNode":
        """Recursively merge ``other`` on top of ``self`` (in place)."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and isinstance(v, dict):
                self[k].merge_from(v)
            else:
                self[k] = v
        return self

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                node[part] = ConfigNode()
            node = node[part]
        node[parts[-1]] = value

    def to_plain(self) -> dict:
        def conv(v):
            if isinstance(v, ConfigNode):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def to_yaml(self) -> str:
        buf = io.StringIO()
        yaml.safe_dump(self.to_plain(), buf, sort_keys=True)
        return buf.getvalue()


def _defaults() -> ConfigNode:
    """The full default tree. Mirrors `utils/config.py:6-247` plus all keys the
    reference reads without defaulting (SURVEY.md §2.7)."""
    c = ConfigNode()

    # -- experiment ------------------------------------------------------
    c.LOGDIR = "/tmp/scl_transformer_logs"
    c.DATASETS = ["pouring"]
    c.SSL = True
    c.PATH_TO_DATASET = "pouring"
    c.TRAINING_ALGO = "scl"  # tcc, tcn, scl, classification
    c.IMAGE_SIZE = 224
    c.NUM_GPUS = 1  # kept for YAML compat; means "devices" here
    c.SHARD_ID = 0
    c.RNG_SEED = 1
    # Reference: set only via YAML (`train.py:109`). Here it selects bf16
    # autocast for the frame backbone (bf16 has fp32's exponent range, so no
    # GradScaler is needed).
    c.USE_AMP = False

    # -- train -----------------------------------------------------------
    c.TRAIN = ConfigNode()
    c.TRAIN.MAX_EPOCHS = 500
    c.TRAIN.BATCH_SIZE = 1
    c.TRAIN.NUM_FRAMES = 240
    # None = disabled; else int epoch count (`train.py:81-91`).
    c.TRAIN.BACKBONE_WARMUP = None

    # -- eval ------------------------------------------------------------
    c.EVAL = ConfigNode()
    c.EVAL.BATCH_SIZE = 1
    c.EVAL.NUM_FRAMES = 240
    c.EVAL.VAL_INTERVAL = 50
    c.EVAL.TASKS = ["kendalls_tau", "retrieval", "classification", "event_completion"]
    c.EVAL.FRAMES_PER_BATCH = 1000
    c.EVAL.KENDALLS_TAU_STRIDE = 5
    c.EVAL.KENDALLS_TAU_DISTANCE = "sqeuclidean"
    c.EVAL.CLASSIFICATION_FRACTIONS = [0.1, 0.5, 1.0]
    c.EVAL.RETRIEVAL_KS = [5, 10, 15]
    # Beyond-reference: pack up to N same-bucket video chunks into one
    # batched eval forward (evaluation/embedding.py). 1 = reference-exact
    # per-video sweep; >1 is bit-identical (per-entry key masks + per-entry
    # positional ramps). On-chip: +17% frames/s for the ResNet family (P=2),
    # -20% for MVF/ViT at bucket 128 (tools/bench_eval.py --pack) — enable
    # per-workload.
    c.EVAL.PACK_VIDEOS = 1
    # Beyond-reference: frame-packed extraction — the per-frame trunk runs
    # on densely packed fixed-size blocks across video boundaries (zero pad
    # compute); only the cheap temporal head runs on padded buckets
    # (evaluation/embedding.py::_iter_frameflat). Embeddings match the
    # per-video sweep (reference head chunk boundaries preserved).
    # VRL_EVAL_FLAT=0/1 force-overrides; FLAT_BLOCK 0 = auto
    # (min(EVAL.FRAMES_PER_BATCH, 128)).
    c.EVAL.FLAT_EXTRACT = False
    c.EVAL.FLAT_BLOCK = 0
    # FineGym-only keys (`evaluate_finegym.py:190,207,211`, `resnet_c2d.py:18`).
    c.EVAL.CLASS_NUM = 99
    c.EVAL.CLASSIFICATION_LR = 50.0
    c.EVAL.CLASSIFICATION_EPOCHS = 100

    # -- model -----------------------------------------------------------
    c.MODEL = ConfigNode()
    c.MODEL.EMBEDDER_TYPE = "transformer"  # transformer, conv, vanilla
    c.MODEL.TRAIN_BASE = "frozen"  # frozen, train_all, only_bn
    c.MODEL.L2_NORMALIZE = True
    c.MODEL.PROJECTION = True
    c.MODEL.PROJECTION_HIDDEN_SIZE = 512
    c.MODEL.PROJECTION_SIZE = 128
    # Optional CLS residual (`transformer.py:30-36`); warm start ckpt path
    # (`models/__init__.py:50-59`).
    c.MODEL.CLS_RES = False
    c.MODEL.PRETRAINED_CHECKPOINT = None
    # TPU-native addition: rematerialize trainable-tail activations
    # (jax.checkpoint) to trade FLOPs for HBM on partial-finetune configs.
    c.MODEL.REMAT = False
    # TPU-native addition: W8A8 dynamic-int8 matmuls in the FROZEN backbone
    # (2x MXU rate on v5e; ops/quant.py). Ignored for TRAIN_BASE=train_all.
    c.MODEL.QUANTIZE_BACKBONE = False

    c.MODEL.BASE_MODEL = ConfigNode()
    c.MODEL.BASE_MODEL.NETWORK = "Resnet50_byol"
    c.MODEL.BASE_MODEL.LAYER = 3
    c.MODEL.BASE_MODEL.FRAMES_PER_BATCH = 40
    c.MODEL.BASE_MODEL.OUT_CHANNEL = 2048  # set by model factory, kept for compat

    e = ConfigNode()
    c.MODEL.EMBEDDER_MODEL = e
    e.HIDDEN_SIZE = 256
    e.D_FF = 1024
    e.NUM_HEADS = 8
    e.NUM_LAYERS = 3
    e.CONV_LAYERS = [[256, 3, 1], [256, 3, 1]]
    e.FLATTEN_METHOD = "max_pool"
    e.FC_LAYERS = [[256, True], [256, True]]
    e.CAPACITY_SCALAR = 2
    e.EMBEDDING_SIZE = 128
    e.FC_DROPOUT_RATE = 0.1
    e.USE_BN = True
    # MV-Former options: defaults replicate the reference's presence-check
    # fallbacks (`transformer.py:22-25,66-70`, `mvformer.py:23-54,100-109,
    # 283-313`).
    e.FUSION_TYPE = "late"  # late | smart
    e.LATE_TYPE = "cls"  # cls | spatial
    e.SMART_FEATS = None  # None -> block 11 only; else "11" or "3,7,11"
    e.SMART_TOKENS = 5
    e.SMART_DYNAMIC_TOKENS = 0
    e.SMART_POOL_CHANNELS = 384
    e.SMART_ONE_HOT = "none"  # none | pool | enc
    e.SMART_FINAL = "max"  # max | one | avg | lin
    e.SMART_DISJOINT = False
    e.SMART_LN_KEYS = False
    e.VAL_PASS = False
    e.FIXED_WIDTH_BASELINE = False
    e.FUSION_CLS = False
    e.CLS_GRAD_ONLY = False
    e.DYNAMIC_CTRL = "separate"  # separate | first | average

    # -- SCL -------------------------------------------------------------
    c.SCL = ConfigNode()
    c.SCL.LABEL_VARIENCE = 10.0  # [sic] reference spelling is part of the schema
    c.SCL.SOFTMAX_TEMPERATURE = 0.1
    c.SCL.POSITIVE_TYPE = "gauss"
    c.SCL.NEGATIVE_TYPE = "single_noself"
    c.SCL.POSITIVE_WINDOW = 5

    # -- TCC -------------------------------------------------------------
    c.TCC = ConfigNode()
    c.TCC.CYCLE_LENGTH = 2
    c.TCC.LABEL_SMOOTHING = 0.1
    c.TCC.SOFTMAX_TEMPERATURE = 0.1
    c.TCC.LOSS_TYPE = "regression_mse_var"
    c.TCC.NORMALIZE_INDICES = True
    c.TCC.VARIANCE_LAMBDA = 0.001
    c.TCC.FRACTION = 1.0
    c.TCC.HUBER_DELTA = 0.1
    c.TCC.SIMILARITY_TYPE = "l2"

    # -- TCN -------------------------------------------------------------
    c.TCN = ConfigNode()
    c.TCN.POSITIVE_WINDOW = 5
    c.TCN.REG_LAMBDA = 0.002

    # -- optimizer -------------------------------------------------------
    c.OPTIMIZER = ConfigNode()
    c.OPTIMIZER.TYPE = "AdamOptimizer"  # AdamOptimizer | MomentumOptimizer | AdamWOptimizer
    c.OPTIMIZER.WEIGHT_DECAY = 1e-5
    c.OPTIMIZER.GRAD_CLIP = 10
    c.OPTIMIZER.LR = ConfigNode()
    c.OPTIMIZER.LR.INITIAL_LR = 1e-4
    c.OPTIMIZER.LR.DECAY_TYPE = "cosine"  # fixed | cosine | cosinewarmup | multiply
    c.OPTIMIZER.LR.WARMUP_LR = 1e-4
    c.OPTIMIZER.LR.FINAL_LR = 0.0
    c.OPTIMIZER.LR.NUM_WARMUP_STEPS = 1
    c.OPTIMIZER.LR.DECAY_RATE = 0.999  # used by 'multiply' (`utils/optimizer.py:98-100`)

    # -- data ------------------------------------------------------------
    c.DATA = ConfigNode()
    c.DATA.FRACTION = 1.0
    c.DATA.ADDITION_TRAINSET = False
    c.DATA.SAMPLING_STRATEGY = "time_augment"
    c.DATA.NUM_CONTEXTS = 1
    c.DATA.CONTEXT_STRIDE = 1
    c.DATA.SAMPLING_REGION = 1.5
    c.DATA.CONSISTENT_OFFSET = 0.2
    c.DATA.FRAME_LABELS = True
    c.DATA.SAMPLE_ALL_STRIDE = 1
    c.DATA.NUM_WORKERS = 4
    c.DATA.SAMPLE_FIX = False  # alternate sampler (`pouring.py:46-48,150-154`)
    # Beyond-reference: host-RAM decoded-frame cache budget (data/cache.py).
    # 0 = off (exact reference re-decode-per-epoch behavior). Sized > the
    # dataset's decoded bytes, training is decode-free after epoch 0.
    c.DATA.DECODE_CACHE_MB = 0
    # Beyond-reference: H2D prefetch depth — device_put runs on a background
    # thread so the transfer overlaps step compute (train/trainer.py
    # _batch_stream). 0 = serial reference loop semantics.
    c.DATA.DEVICE_PREFETCH = 2

    # -- augmentation ----------------------------------------------------
    a = ConfigNode()
    c.AUGMENTATION = a
    a.STRENGTH = 1.0
    a.RANDOM_FLIP = True
    a.RANDOM_CROP = True
    a.BRIGHTNESS = True
    a.BRIGHTNESS_MAX_DELTA = 0.8
    a.CONTRAST = True
    a.CONTRAST_MAX_DELTA = 0.8
    a.HUE = True
    a.HUE_MAX_DELTA = 0.2
    a.SATURATION = True
    a.SATURATION_MAX_DELTA = 0.8

    # -- logging / checkpoint -------------------------------------------
    c.LOGGING = ConfigNode()
    c.LOGGING.REPORT_INTERVAL = 20
    c.CHECKPOINT = ConfigNode()
    c.CHECKPOINT.SAVE_INTERVAL = 50
    # TPU-native addition (reference saves per-epoch only): > 0 also saves a
    # mid-epoch checkpoint every N train iters, and auto-resume continues
    # from the exact iteration — preemption resilience for TPU pods. The
    # resumed trajectory is bit-identical to an uninterrupted run (per-epoch
    # deterministic shuffle + iter-folded RNG + epoch-pure LR), tested in
    # tests/test_train.py::test_mid_epoch_resume_exact_trajectory.
    c.CHECKPOINT.SAVE_EVERY_N_ITERS = 0

    # -- parallelism (TPU-native addition; reference is DP-only) ---------
    c.PARALLEL = ConfigNode()
    # >1 builds a 2-D (data, model) mesh and head-shards attention
    # (parallel/sharding.py). 1 = pure data parallelism (reference parity).
    c.PARALLEL.TENSOR_PARALLELISM = 1
    # with TENSOR_PARALLELISM > 1: Ulysses-style sequence parallelism —
    # token-sharded activations outside attention, head-sharded inside
    # (all-to-alls inserted by XLA). For max-sequence configs (fg288).
    c.PARALLEL.SEQUENCE_PARALLELISM = False
    return c


def get_cfg() -> ConfigNode:
    """A fresh copy of the default config (`utils/config.py:250-254`)."""
    return copy.deepcopy(_defaults())


def _coerce(new_value: str, old_value: Any) -> Any:
    """Coerce a string CLI override to the type of the default it replaces
    (`utils/parser.py:46-61`)."""
    if isinstance(old_value, bool):
        if isinstance(new_value, bool):
            return new_value
        return str(new_value).lower() in ("true", "1", "yes")
    if isinstance(old_value, int) and not isinstance(old_value, bool):
        try:
            return int(new_value)
        except ValueError:
            return float(new_value)
    if isinstance(old_value, float):
        return float(new_value)
    if isinstance(old_value, (list, tuple)):
        v = yaml.safe_load(new_value) if isinstance(new_value, str) else new_value
        return v if isinstance(v, list) else [v]
    if old_value is None:
        return yaml.safe_load(new_value) if isinstance(new_value, str) else new_value
    return new_value


def load_yaml_into(cfg: ConfigNode, path: str) -> ConfigNode:
    """Deep-merge a YAML file into ``cfg`` (reference: `utils/parser.py:74-78`)."""
    with open(path) as f:
        overlay = yaml.safe_load(f)
    if overlay:
        cfg.merge_from(overlay)
    return cfg


def apply_opts(cfg: ConfigNode, opts: list | None) -> ConfigNode:
    """Apply ``KEY.PATH value`` pair overrides (`utils/parser.py:80-87`)."""
    if not opts:
        return cfg
    if len(opts) % 2 != 0:
        raise ValueError("--opts expects KEY VALUE pairs, got odd count")
    for key, value in zip(opts[0::2], opts[1::2]):
        old = cfg.get_path(key)
        cfg.set_path(key, _coerce(value, old))
    return cfg
