"""The CARL model: ResNet-50 frame backbone -> temporal transformer head ->
(projection | classifier), and the config resolution that wires it.

Counterpart of `video_rep_learning_tpu/models/carl.py` for the ResNet
backbone with the `late` transformer head. Module names follow the reference
`TransformerModel` state dict (`backbone`, `res_finetune`, `embed`,
`ssl_projection`, `classifier`), so its checkpoints load strictly.

- The frozen trunk runs without grad, in eval-mode BN, in chunks of
  MODEL.BASE_MODEL.FRAMES_PER_BATCH frames, each at its exact size (with
  TRAIN_BASE train_all it runs unchunked and differentiable, its BN still on
  running statistics, as in the JAX package).
- In train mode the finetuned tail and the head use batch-statistic BN and
  dropout; `set_trainable` marks the parameters the optimizer updates.
- Under USE_AMP the backbone (trunk and finetuned tail) runs under bf16
  autocast; the head stays fp32, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConfigNode
from ..data.splits import DATASET_TO_NUM_CLASSES
from .embedder import Classifier, MLPHead, TransformerEmbModel
from .resnet import ResNet50Stages, ResNet50Trunk

@dataclass(frozen=True)
class ModelSpec:
    """Static wiring resolved from the config."""

    resnet_trunk_upto: int
    resnet_finetune_start: int    # 0 = no finetuned tail
    frames_per_batch: int
    projection: bool
    l2_normalize: bool
    num_classes: int
    embedding_size: int
    hidden_size: int
    d_ff: int
    num_heads: int
    num_layers: int
    fc_channels: Tuple[int, ...]
    drop_rate: float
    flatten_method: str
    train_num_frames: int
    projection_hidden: int
    use_amp: bool
    train_base: str = "frozen"


def resolve_model_spec(cfg: ConfigNode) -> ModelSpec:
    """The JAX package's `resolve_model_spec` for the branch ported so far:
    a ResNet backbone with the late-fusion transformer head."""
    m = cfg.MODEL
    e = m.EMBEDDER_MODEL
    network = m.BASE_MODEL.NETWORK
    if network.startswith("TIMM-"):
        raise NotImplementedError("ViT backbones come with the MV-Former slice")
    if m.EMBEDDER_TYPE != "transformer":
        raise NotImplementedError(
            f"EMBEDDER_TYPE {m.EMBEDDER_TYPE} comes with the TCC/TCN slice")
    if e.FUSION_TYPE != "late":
        raise NotImplementedError(
            f"FUSION_TYPE {e.FUSION_TYPE} comes with the MV-Former slice")
    if e.LATE_TYPE not in ("cls", "spatial"):
        raise ValueError(f"LATE_TYPE {e.LATE_TYPE}")
    if m.CLS_RES:
        raise ValueError("CLS_RES cannot be used with late fusion")
    if e.FUSION_CLS or e.CLS_GRAD_ONLY:
        raise ValueError("FUSION_CLS / CLS_GRAD_ONLY need a timm backbone "
                         "with smart fusion")
    layer = m.BASE_MODEL.LAYER
    upto, ft_start = {3: (3, 4), 2: (2, 3)}.get(layer, (4, 0))
    cap = e.CAPACITY_SCALAR
    if cfg.DATASETS[0] == "finegym":
        num_classes = cfg.EVAL.CLASS_NUM
    else:
        num_classes = DATASET_TO_NUM_CLASSES.get(cfg.DATASETS[0], 2)
    return ModelSpec(
        resnet_trunk_upto=upto,
        resnet_finetune_start=ft_start,
        frames_per_batch=m.BASE_MODEL.FRAMES_PER_BATCH,
        projection=m.PROJECTION,
        l2_normalize=m.L2_NORMALIZE,
        num_classes=num_classes,
        embedding_size=e.EMBEDDING_SIZE,
        hidden_size=e.HIDDEN_SIZE,
        d_ff=e.D_FF,
        num_heads=e.NUM_HEADS,
        num_layers=e.NUM_LAYERS,
        fc_channels=tuple(int(ch) * cap for ch, _ in (e.FC_LAYERS or [])),
        drop_rate=e.FC_DROPOUT_RATE,
        flatten_method=e.FLATTEN_METHOD,
        train_num_frames=cfg.TRAIN.NUM_FRAMES,
        projection_hidden=m.PROJECTION_SIZE,
        use_amp=bool(cfg.USE_AMP),
        train_base=m.TRAIN_BASE,
    )


def _l2norm(x, dim=-1, eps=1e-12):
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return F.normalize(x, dim=dim, eps=eps)


class CARLModel(nn.Module):
    """x (BV, T, 3, H, W) or (BV, T, H, W, 3) float -> (BV, T, emb), or
    logits with `classification=True`. `video_masks` is (BV, 1, T)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.backbone = ResNet50Trunk(spec.resnet_trunk_upto)
        self.res_finetune = (ResNet50Stages(spec.resnet_finetune_start)
                             if spec.resnet_finetune_start else None)
        # 2048 channels for every LAYER: layer4 ends either the trunk or the tail
        self.embed = TransformerEmbModel(
            2048, spec.hidden_size, spec.embedding_size, spec.fc_channels,
            spec.drop_rate, spec.flatten_method, spec.num_layers,
            spec.num_heads, spec.d_ff, spec.train_num_frames)
        self.ssl_projection = (MLPHead(spec.embedding_size,
                                       spec.projection_hidden)
                               if spec.projection else None)
        self.classifier = Classifier(spec.embedding_size, spec.num_classes,
                                     spec.drop_rate)

    def train(self, mode: bool = True):
        """The frozen trunk always keeps eval-mode BN (reference
        `backbone.eval()`); the rest follows `mode`."""
        super().train(mode)
        self.backbone.eval()
        return self

    def _autocast(self, device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.spec.use_amp)

    def _run_frozen(self, frames):
        """The frozen trunk over (N, 3, H, W) frames in FRAMES_PER_BATCH
        chunks, without grad and with eval-mode BN (whole and differentiable
        with TRAIN_BASE train_all)."""
        if self.spec.train_base == "train_all":
            with self._autocast(frames.device):
                return self.backbone(frames)
        chunk = self.spec.frames_per_batch
        with torch.no_grad(), self._autocast(frames.device):
            outs = [self.backbone(frames[i:i + chunk])
                    for i in range(0, frames.shape[0], chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _backbone_features(self, frames):
        """Frozen trunk + finetuned tail: (N, 3, H, W) -> (N, C, h, w)."""
        feats = self._run_frozen(frames)
        if self.res_finetune is not None:
            with self._autocast(frames.device):
                feats = self.res_finetune(feats)
        return feats

    @staticmethod
    def _nchw(frames):
        """(N, H, W, 3) channels-last frames -> an (N, 3, H, W) view."""
        if frames.shape[-1] == 3 and frames.shape[1] != 3:
            return frames.permute(0, 3, 1, 2)
        return frames

    def forward(self, x, num_frames: Optional[int] = None, video_masks=None,
                project: bool = False, classification: bool = False,
                true_seq_len=None):
        BV, T = x.shape[:2]
        feats = self._backbone_features(self._nchw(x.flatten(0, 1)))
        feats = feats.view((BV, T) + feats.shape[1:])
        return self.head_embs(feats, None, num_frames, video_masks=video_masks,
                              project=project, classification=classification,
                              true_seq_len=true_seq_len)

    def backbone_flat(self, x):
        """The per-frame backbone on a flat (N, H, W, 3) or (N, 3, H, W)
        block: returns (feats (N, C, h, w), None), the arrays `forward` feeds
        its head. The None stands for the ViT CLS feature."""
        return self._backbone_features(self._nchw(x)), None

    def head_embs(self, feats, cls_emb=None, num_frames: Optional[int] = None,
                  video_masks=None, project: bool = False,
                  classification: bool = False, true_seq_len=None):
        """Everything after the backbone: feats (BV, T, C, h, w) ->
        embeddings (BV, T, emb) fp32."""
        emb = self.embed(feats, video_masks=video_masks,
                         true_len=true_seq_len).float()
        if self.ssl_projection is not None and project:
            emb = _l2norm(self.ssl_projection(emb))
        elif self.spec.l2_normalize:
            emb = _l2norm(emb)
        if classification:
            return self.classifier(emb)
        return emb


def set_trainable(model: CARLModel, train_base: str, classifier: bool = False):
    """Mark what the optimizer updates (`utils/optimizer.py:29-42`) and return
    those (name, parameter) pairs in registration order: the frozen trunk
    (`backbone.*`) trains only with TRAIN_BASE train_all, or its BN
    parameters only with only_bn; the classifier only for the classification
    algorithm (the JAX package creates it only then); everything else
    trains."""
    trainable = []
    for name, p in model.named_parameters():
        if name.startswith("classifier."):
            keep = classifier
        elif name.startswith("backbone.") and train_base != "train_all":
            module = model.get_submodule(name.rsplit(".", 1)[0])
            keep = (train_base == "only_bn"
                    and isinstance(module, nn.modules.batchnorm._BatchNorm))
        else:
            keep = True
        p.requires_grad_(keep)
        if keep:
            trainable.append((name, p))
    return trainable


def build_model(cfg: ConfigNode, device="cpu") -> CARLModel:
    """The model for a config, in eval mode on `device`. The backbone keeps
    channels_last weights, the layout cuDNN's bf16 convolutions prefer."""
    model = CARLModel(resolve_model_spec(cfg))
    model.backbone.to(memory_format=torch.channels_last)
    if model.res_finetune is not None:
        model.res_finetune.to(memory_format=torch.channels_last)
    return model.to(device).eval()
