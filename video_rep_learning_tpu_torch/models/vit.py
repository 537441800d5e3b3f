"""DINO-style Vision Transformer frame backbone, fully frozen.

Counterpart of `video_rep_learning_tpu/models/vit.py` (`ViTSpec`,
`VIT_SPECS`, `parse_smart_feats`, `ViTBlock`, `ViTFrontEnd` with
`include_norm`), with the timm `VisionTransformer` parameter names
(`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.N.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}`, `norm`), so the reference MV-Former
checkpoint's `backbone.model.*` loads strictly.

Each block runs the port's kernels on CUDA (their plain versions on CPU):
the attention half-block (`ops/vit_block.py`), LN2 + fc1 + exact GELU
(`ops/matmul.py`), then fc2 and the residual as a plain product, as the
JAX package leaves fc2 to XLA. After the last block the final norm is the
LayerNorm kernel (`ops/layernorm.py`).

With a bf16 compute type (USE_AMP) the front end keeps a bf16 copy of its
matrices and of what flax's `dtype=bf16` casts (patch embed, cls and
position embeddings, fc2's bias), made once at first use after a load; the
LN parameters and the kernels' biases stay fp32, as the Pallas kernels take
them. The partially frozen split (`ViTBackEnd`) comes with MV-Former
training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import fused_layernorm
from ..ops.matmul import ln_matmul_bias_act
from ..ops.vit_block import vit_attention_block

LN_EPS = 1e-6  # timm's ViT LayerNorm


@dataclass(frozen=True)
class ViTSpec:
    embed_dim: int
    depth: int
    num_heads: int
    patch: int
    img_size: int = 224
    mlp_ratio: float = 4.0

    @property
    def grid(self) -> int:
        return self.img_size // self.patch

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


# name (after the 'TIMM-' prefix) -> spec; the JAX package's table
VIT_SPECS = {
    "vit_small_patch16_224.dino": ViTSpec(384, 12, 6, 16),
    "vit_small_patch8_224.dino": ViTSpec(384, 12, 6, 8),
    "vit_small_patch14_dinov2.lvd142m": ViTSpec(384, 12, 6, 14, img_size=518),
    "vit_base_patch16_224.dino": ViTSpec(768, 12, 12, 16),
    "vit_base_patch8_224.dino": ViTSpec(768, 12, 12, 8),
    "vit_base_patch14_dinov2.lvd142m": ViTSpec(768, 12, 12, 14, img_size=518),
    "vit_large_patch14_dinov2.lvd142m": ViTSpec(1024, 24, 16, 14, img_size=518),
    "vit_giant_patch14_dinov2.lvd142m": ViTSpec(1536, 40, 24, 14, img_size=518),
    "vit_tiny_test": ViTSpec(32, 2, 2, 8, img_size=32),
}


def parse_smart_feats(smart_feats, default_block: int) -> Tuple[int, ...]:
    """SMART_FEATS ("3,7,11" | "11" | int | None) -> block indices; None ->
    (default_block,)."""
    if smart_feats is None:
        return (default_block,)
    text = str(smart_feats)
    return tuple(int(p) for p in (text.split(",") if "," in text else [text]))


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-LN block: x + proj(MHA(LN1(x))), then x + fc2(GELU(fc1(LN2(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def matrices(self, dtype):
        """(wqkv, wproj, wfc1, wfc2, bfc2) in the compute type."""
        return tuple(t.detach().to(dtype) for t in (
            self.attn.qkv.weight, self.attn.proj.weight, self.mlp.fc1.weight,
            self.mlp.fc2.weight, self.mlp.fc2.bias))

    def forward(self, x, mats=None):
        """x (B, N, D) in the compute type; `mats` from `matrices` (default:
        the parameters' own type)."""
        wqkv, wproj, wfc1, wfc2, bfc2 = mats or self.matrices(x.dtype)
        x = vit_attention_block(x, self.norm1.weight, self.norm1.bias, wqkv,
                                self.attn.qkv.bias, wproj, self.attn.proj.bias,
                                self.num_heads, LN_EPS)
        y = ln_matmul_bias_act(x, self.norm2.weight, self.norm2.bias, wfc1,
                               self.mlp.fc1.bias, "gelu_exact", eps=LN_EPS)
        return x + F.linear(y, wfc2, bfc2)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class VisionTransformer(nn.Module):
    """The timm parameter tree (the reference wraps it as `backbone.model`)."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        D = spec.embed_dim
        self.patch_embed = PatchEmbed(spec.patch, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + spec.num_patches, D))
        self.blocks = nn.ModuleList(ViTBlock(D, spec.num_heads, spec.mlp_ratio)
                                    for _ in range(spec.depth))
        self.norm = nn.LayerNorm(D, eps=LN_EPS)
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                nn.init.trunc_normal_(lin.weight, std=0.02)
                nn.init.zeros_(lin.bias)


class ViTFrontEnd(nn.Module):
    """The fully frozen ViT: (N, 3, H, W) frames -> (concat of the tapped
    block outputs (N, 1 + P, D * taps), pre-norm with the CLS token; the
    final-norm CLS feature (N, D)), computed in `dtype`."""

    def __init__(self, spec: ViTSpec, tap_blocks: Tuple[int, ...],
                 dtype=torch.float32):
        super().__init__()
        self.spec = spec
        self.tap_blocks = tuple(tap_blocks)
        self.dtype = dtype
        self.model = VisionTransformer(spec)
        self._cast: Optional[tuple] = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._cast = None  # new weights: the compute-type copy is stale
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._cast = None  # moved or converted: rebuild on the next call
        return super()._apply(fn, *args, **kwargs)

    def _compute_weights(self):
        """(patch weight, patch bias, cls, pos, per-block matrices) in the
        compute type: the parameters themselves in fp32, else a copy made
        once (outside inference mode, so any later mode may use it)."""
        m, dt = self.model, self.dtype
        if dt == torch.float32:
            return (m.patch_embed.proj.weight, m.patch_embed.proj.bias,
                    m.cls_token, m.pos_embed, [None] * len(m.blocks))
        if self._cast is None:
            with torch.inference_mode(False), torch.no_grad():
                self._cast = tuple(t.detach().to(dt) for t in (
                    m.patch_embed.proj.weight, m.patch_embed.proj.bias,
                    m.cls_token, m.pos_embed)) + (
                        [blk.matrices(dt) for blk in m.blocks],)
        return self._cast

    def forward(self, x):
        pw, pb, cls, pos, mats = self._compute_weights()
        x = F.conv2d(x.to(self.dtype), pw, pb, stride=self.spec.patch)
        x = x.flatten(2).transpose(1, 2)  # (N, P, D), patches row-major
        x = torch.cat([cls.expand(x.shape[0], 1, -1), x], dim=1) + pos
        taps = []
        for i, blk in enumerate(self.model.blocks):
            x = blk(x, mats[i])
            if i in self.tap_blocks:
                taps.append(x)
        normed = fused_layernorm(x, self.model.norm.weight, self.model.norm.bias,
                                 LN_EPS)
        feats = (None if not taps else taps[0] if len(taps) == 1
                 else torch.cat(taps, dim=2))
        return feats, normed[:, 0]
