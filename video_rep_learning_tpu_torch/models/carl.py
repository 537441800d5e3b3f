"""The CARL / MV-Former model: frame backbone -> temporal fusion head ->
(projection | classifier), and the config resolution that wires it.

Counterpart of `video_rep_learning_tpu/models/carl.py`: the `late`
transformer head (CARL) over a ResNet or a timm ViT, and the `smart`
multi-entity head (MV-Former) over a fully or partially frozen timm ViT or
a ResNet.
Module names follow the reference `TransformerModel` state dict
(`backbone`, `backbone.model` for a ViT, `res_finetune`, `embed`,
`ssl_projection`, `classifier`, `cls_res_res`), so its checkpoints load
strictly; a late-cls ViT's reference dict holds the bare timm model under
`backbone.*`, which `models/weights.py` maps onto `backbone.model.*`.

- The frozen trunk runs without grad, in eval-mode BN, in chunks of
  MODEL.BASE_MODEL.FRAMES_PER_BATCH frames, each at its exact size (with
  TRAIN_BASE train_all it runs unchunked and differentiable, its BN still on
  running statistics, as in the JAX package).
- In train mode the finetuned tail and the head use batch-statistic BN and
  dropout; `set_trainable` marks the parameters the optimizer updates.
- Under USE_AMP the ResNet (trunk and finetuned tail) runs under bf16
  autocast and the ViT in bf16 (`models/vit.py`); the head stays fp32, as in
  the JAX package.
- A fully frozen ViT (LAYER >= its depth) runs forward only; the head
  trains. A partially frozen one (LAYER = L below the depth) runs blocks
  0..L-1 forward only in chunks, then the trainable `ViTBackEnd` (blocks
  L.. and the final norm, `res_finetune`) with grad on all the frames at
  once, through `torch.utils.checkpoint` under MODEL.REMAT (the JAX
  package's `nn.remat`). `backbone_warmup_active` (TRAIN.BACKBONE_WARMUP)
  stops the gradient at the backbone's features in the smart head, as in
  the JAX package: with a partial ViT no gradient then reaches the back end
  through them.
- The conv and vanilla embedders (EMBEDDER_TYPE conv / vanilla, the TCC /
  TCN configs) take DATA.NUM_CONTEXTS frames a step: the conv path runs the
  ResNet through layer3 (1024 channels) with LAYER 3, else through layer4,
  and never a finetuned tail; vanilla with LAYER 3 has the layer4 tail.
- Late fusion over a ViT (the `ablate_dinoB8_*` configs): LATE_TYPE cls
  feeds the late head the final-norm CLS feature as a 1x1 grid; LATE_TYPE
  spatial the tapped pre-norm patch tokens (SMART_FEATS) on the g x g grid.
  The head pools the grid over its spatial axes in the backbone's compute
  type, then computes in fp32.
- Still to come, each with its slice: a ViT under TRAIN_BASE train_all,
  QUANTIZE_BACKBONE (W8A8 int8 ViT matmuls).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ConfigNode
from ..data.splits import DATASET_TO_NUM_CLASSES
from .embedder import Classifier, ConvEmbed, MLPHead, TransformerEmbModel
from .mvformer import MultiEntityTransformerEmbModel
from .resnet import ResNet50Stages, ResNet50Trunk
from .vit import VIT_SPECS, ViTBackEnd, ViTFrontEnd, ViTSpec, parse_smart_feats


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
    embedder_type: str = "transformer"  # transformer | conv | vanilla
    conv_params: Tuple[Tuple[int, int, int], ...] = ()  # conv: (ch, k, tpad)
    num_contexts: int = 1         # conv / vanilla: frames a step
    fusion_type: str = "late"     # late | smart
    late_type: str = "cls"        # late fusion over a ViT: cls | spatial
    vit_spec: Optional[ViTSpec] = None  # None = ResNet backbone
    vit_front_blocks: int = 0     # frozen ViT blocks (the depth: fully frozen)
    remat: bool = False           # MODEL.REMAT: recompute the trainable tail
    tap_blocks: Tuple[int, ...] = ()
    out_channel: int = 2048       # channels fed to the embedder
    use_cls_res: bool = False
    # MV-Former head
    num_static: int = 0
    num_dynamic: int = 0
    pool_channels: int = 0
    d_dyn_in: int = 0
    one_hot_pos: str = "none"
    smart_final: str = "max"
    fixed_width_baseline: bool = False
    val_pass: bool = False
    disjoint: bool = False
    ln_keys: bool = False
    dyn_ctrl: str = "separate"


def _resolve_vit(cfg, name, fusion_type):
    """(spec, taps, out_channel, frozen blocks) of a timm ViT with the smart
    or the late head, fully frozen (LAYER outside [0, depth)) or frozen up
    to block LAYER. Late-cls taps nothing and feeds the embed width; the
    other ViT wirings raise, naming the slice that brings them."""
    m = cfg.MODEL
    if name not in VIT_SPECS:
        raise ValueError(f"unknown TIMM model {name}")
    vit = VIT_SPECS[name]
    if m.EMBEDDER_TYPE != "transformer":
        raise NotImplementedError(
            f"EMBEDDER_TYPE {m.EMBEDDER_TYPE} over a ViT backbone (no shipped "
            "config) comes with ROADMAP queue 1 item 8")
    if m.TRAIN_BASE == "train_all":
        raise NotImplementedError(
            "a ViT trained end to end (TRAIN_BASE train_all) comes in a later "
            "slice (the patch-embed gradient and an unchunked front)")
    if m.QUANTIZE_BACKBONE:
        raise NotImplementedError(
            "QUANTIZE_BACKBONE (W8A8 int8 ViT matmuls) comes in a later slice")
    taps = ()
    if fusion_type != "late" or m.EMBEDDER_MODEL.LATE_TYPE == "spatial":
        taps = parse_smart_feats(m.EMBEDDER_MODEL.SMART_FEATS, vit.depth - 1)
        if any(t < 0 or t >= vit.depth for t in taps):
            raise ValueError(f"SMART_FEATS taps {taps} out of range for {name} "
                             f"(depth {vit.depth})")
    layer = m.BASE_MODEL.LAYER
    front = vit.depth if layer < 0 or layer >= vit.depth else layer
    if front < vit.depth and any(t < front for t in taps):
        raise ValueError("SMART_FEATS tap below the frozen/finetune split "
                         "(`transformer.py:104-114`)")
    return vit, taps, vit.embed_dim * max(1, len(taps)), front


def resolve_model_spec(cfg: ConfigNode) -> ModelSpec:
    """The JAX package's `resolve_model_spec` for the wirings ported so far:
    the late-fusion head (CARL) over a ResNet or a timm ViT, the conv or
    vanilla embedder (TCC / TCN), and the smart multi-entity head
    (MV-Former) over a fully or partially frozen timm ViT or a ResNet."""
    m = cfg.MODEL
    e = m.EMBEDDER_MODEL
    network = m.BASE_MODEL.NETWORK
    fusion_type = e.FUSION_TYPE
    embedder_type = m.EMBEDDER_TYPE
    if embedder_type not in ("transformer", "conv", "vanilla"):
        raise ValueError(f"EMBEDDER_TYPE {embedder_type}")
    if fusion_type not in ("late", "smart"):
        raise ValueError(f"FUSION_TYPE {fusion_type}")
    if e.LATE_TYPE not in ("cls", "spatial"):
        raise ValueError(f"LATE_TYPE {e.LATE_TYPE}")
    if m.CLS_RES and fusion_type == "late":
        raise ValueError("CLS_RES cannot be used with late fusion")
    if e.FUSION_CLS and (not network.startswith("TIMM-") or fusion_type != "smart"):
        raise ValueError("FUSION_CLS requires a timm backbone with smart fusion")
    if e.CLS_GRAD_ONLY and not e.FUSION_CLS:
        raise ValueError("CLS_GRAD_ONLY requires FUSION_CLS")
    vit, taps, upto, ft_start, front = None, (), 4, 0, 0
    if network.startswith("TIMM-"):
        vit, taps, out_channel, front = _resolve_vit(cfg, network[5:], fusion_type)
    else:
        out_channel = 2048  # layer4 ends either the trunk or the tail
        layer = m.BASE_MODEL.LAYER
        if embedder_type == "conv":
            # the trunk through layer3 (1024 channels) or layer4; the conv
            # path never applies a finetuned tail (`resnet_c2d.py:191-226`)
            upto, ft_start = (3, 0) if layer == 3 else (4, 0)
            out_channel = 1024 if layer == 3 else 2048
        elif embedder_type == "vanilla":
            upto, ft_start = (3, 4) if layer == 3 else (4, 0)
        else:
            upto, ft_start = {3: (3, 4), 2: (2, 3)}.get(layer, (4, 0))
        if m.REMAT and ft_start:
            raise NotImplementedError(
                "MODEL.REMAT over a trainable ResNet tail (the JAX package's "
                "nn.remat(ResNet50Stages)) comes with ROADMAP queue 1 item 8; "
                "the port recomputes only a ViT back end")
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
        embedder_type=embedder_type,
        conv_params=tuple((int(ch) * cap, int(k), int(tp))
                          for ch, k, tp in (e.CONV_LAYERS or [])),
        num_contexts=int(cfg.DATA.NUM_CONTEXTS),
        fusion_type=fusion_type,
        late_type=e.LATE_TYPE,
        vit_spec=vit,
        vit_front_blocks=front,
        remat=bool(m.REMAT),
        tap_blocks=taps,
        out_channel=out_channel,
        use_cls_res=bool(m.CLS_RES),
        num_static=e.SMART_TOKENS,
        num_dynamic=e.SMART_DYNAMIC_TOKENS,
        pool_channels=out_channel if e.VAL_PASS else e.SMART_POOL_CHANNELS,
        d_dyn_in=out_channel // max(1, len(taps)),
        one_hot_pos=e.SMART_ONE_HOT,
        smart_final=e.SMART_FINAL,
        fixed_width_baseline=bool(e.FIXED_WIDTH_BASELINE),
        val_pass=bool(e.VAL_PASS),
        disjoint=bool(e.SMART_DISJOINT),
        ln_keys=bool(e.SMART_LN_KEYS),
        dyn_ctrl=e.DYNAMIC_CTRL,
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
        s = spec
        if s.vit_spec is not None:
            self.backbone = ViTFrontEnd(
                s.vit_spec, s.tap_blocks,
                torch.bfloat16 if s.use_amp else torch.float32,
                num_blocks=s.vit_front_blocks)
            partial = self.backbone.model.norm is None
            self.res_finetune = ViTBackEnd(
                s.vit_spec, s.vit_front_blocks, s.tap_blocks,
                s.frames_per_batch) if partial else None
        else:
            self.backbone = ResNet50Trunk(s.resnet_trunk_upto)
            self.res_finetune = (ResNet50Stages(s.resnet_finetune_start)
                                 if s.resnet_finetune_start else None)
        if s.embedder_type != "transformer":  # vanilla: no conv layers
            self.embed = ConvEmbed(
                s.out_channel, s.embedding_size,
                s.conv_params if s.embedder_type == "conv" else (),
                s.fc_channels, s.drop_rate, s.num_contexts)
        elif s.fusion_type == "smart":
            self.embed = MultiEntityTransformerEmbModel(
                s.out_channel, s.hidden_size, s.embedding_size, s.fc_channels,
                s.drop_rate, s.num_layers, s.num_heads, s.d_ff,
                s.train_num_frames, s.num_static, s.num_dynamic,
                s.pool_channels, s.d_dyn_in, s.one_hot_pos, s.smart_final,
                s.fixed_width_baseline, s.val_pass, s.disjoint, s.ln_keys,
                s.dyn_ctrl)
        else:
            self.embed = TransformerEmbModel(
                s.out_channel, s.hidden_size, s.embedding_size, s.fc_channels,
                s.drop_rate, s.flatten_method, s.num_layers, s.num_heads,
                s.d_ff, s.train_num_frames)
        self.ssl_projection = (MLPHead(s.embedding_size, s.projection_hidden)
                               if s.projection else None)
        self.classifier = Classifier(s.embedding_size, s.num_classes,
                                     s.drop_rate)
        if s.use_cls_res:
            self.cls_res_res = nn.Linear(s.vit_spec.embed_dim if s.vit_spec
                                         else s.out_channel, s.embedding_size)

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
        with TRAIN_BASE train_all). A fully frozen ViT returns (taps, CLS)
        pairs, a partial one its token stream, in its own compute type."""
        if self.spec.vit_spec is not None:
            chunk = self.spec.frames_per_batch
            with torch.no_grad():
                outs = [self.backbone(frames[i:i + chunk])
                        for i in range(0, frames.shape[0], chunk)]
            if len(outs) == 1:
                return outs[0]
            if isinstance(outs[0], torch.Tensor):
                return torch.cat(outs)
            # late-cls taps nothing: (None, CLS) a chunk
            return tuple(None if parts[0] is None else torch.cat(parts)
                         for parts in zip(*outs))
        if self.spec.train_base == "train_all":
            with self._autocast(frames.device):
                return self.backbone(frames)
        chunk = self.spec.frames_per_batch
        with torch.no_grad(), self._autocast(frames.device):
            outs = [self.backbone(frames[i:i + chunk])
                    for i in range(0, frames.shape[0], chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _backbone_features(self, frames):
        """(N, 3, H, W) frames -> (features, CLS or None): a ResNet's
        (N, C, h, w) after the finetuned tail; a ViT's tapped tokens without
        the CLS token on the (N, g, g, C) patch grid (late-cls: the CLS
        feature as a (N, 1, 1, C) grid), and its CLS feature."""
        feats = self._run_frozen(frames)
        if self.spec.vit_spec is not None:
            taps, cls = feats if self.res_finetune is None else self._run_back(feats)
            if self.spec.fusion_type == "late" and self.spec.late_type == "cls":
                return cls[:, None, None, :], cls
            g = self.spec.vit_spec.grid
            return taps[:, 1:].reshape(taps.shape[0], g, g, taps.shape[-1]), cls
        if self.res_finetune is not None:
            with self._autocast(frames.device):
                feats = self.res_finetune(feats)
        return feats, None

    def _run_back(self, tokens):
        """The ViT's trainable tail on every frame at once (with grad where
        it is on), recomputed in the backward under MODEL.REMAT."""
        if self.spec.remat and torch.is_grad_enabled():
            return checkpoint(self.res_finetune, tokens, use_reentrant=False)
        return self.res_finetune(tokens)

    @staticmethod
    def _nchw(frames):
        """(N, H, W, 3) channels-last frames -> an (N, 3, H, W) view."""
        if frames.shape[-1] == 3 and frames.shape[1] != 3:
            return frames.permute(0, 3, 1, 2)
        return frames

    def forward(self, x, num_frames: Optional[int] = None, video_masks=None,
                project: bool = False, classification: bool = False,
                backbone_warmup_active: bool = False, true_seq_len=None):
        BV, T = x.shape[:2]
        feats, cls_emb = self.backbone_flat(x.flatten(0, 1))
        feats = feats.view((BV, T) + feats.shape[1:])
        return self.head_embs(feats, cls_emb, num_frames, video_masks=video_masks,
                              project=project, classification=classification,
                              backbone_warmup_active=backbone_warmup_active,
                              true_seq_len=true_seq_len)

    def backbone_flat(self, x):
        """The per-frame backbone on a flat (N, H, W, 3) or (N, 3, H, W)
        block: returns (feats, CLS feature or None), the arrays `forward`
        feeds its head."""
        return self._backbone_features(self._nchw(x))

    def head_embs(self, feats, cls_emb=None, num_frames: Optional[int] = None,
                  video_masks=None, project: bool = False,
                  classification: bool = False,
                  backbone_warmup_active: bool = False, true_seq_len=None):
        """Everything after the backbone: feats (BV, T, ...) as
        `backbone_flat` gives them, cls_emb (BV*T, C) for a ViT ->
        embeddings (BV, T, emb) fp32. `backbone_warmup_active` reaches the
        smart head only, as in the JAX package."""
        s = self.spec
        if s.embedder_type != "transformer":
            emb = self.embed(feats, num_frames or feats.shape[1])
        elif s.fusion_type == "smart":
            if s.vit_spec is None:  # a ResNet's NCHW maps -> NHWC token grids
                feats = feats.permute(0, 1, 3, 4, 2)
            emb = self.embed(feats, video_masks=video_masks, cls_emb=cls_emb,
                             backbone_warmup_active=backbone_warmup_active,
                             true_len=true_seq_len)
        else:
            if s.vit_spec is not None:  # NHWC ViT grids -> the NCHW maps it pools
                feats = feats.permute(0, 1, 4, 2, 3)
            emb = self.embed(feats, video_masks=video_masks, true_len=true_seq_len)
        emb = emb.float()
        if self.ssl_projection is not None and project:
            emb = _l2norm(self.ssl_projection(emb))
        elif s.l2_normalize:
            emb = _l2norm(emb)
        if classification:
            return self.classifier(emb)
        if s.use_cls_res:
            res = self.cls_res_res(cls_emb.float()).view(emb.shape[0],
                                                         emb.shape[1], -1)
            if s.l2_normalize:
                res = _l2norm(res)
            emb = emb + res
            if s.l2_normalize:
                emb = _l2norm(emb)
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
    """The model for a config, in eval mode on `device`. A ResNet keeps
    channels_last weights, the layout cuDNN's bf16 convolutions prefer."""
    model = CARLModel(resolve_model_spec(cfg))
    if model.spec.vit_spec is None:
        model.backbone.to(memory_format=torch.channels_last)
        if model.res_finetune is not None:
            model.res_finetune.to(memory_format=torch.channels_last)
    return model.to(device).eval()
