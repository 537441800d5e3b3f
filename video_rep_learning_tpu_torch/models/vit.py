"""DINO-style Vision Transformer frame backbone: the frozen front end and
the trainable back end.

Counterpart of `video_rep_learning_tpu/models/vit.py` (`ViTSpec`,
`VIT_SPECS`, `parse_smart_feats`, `ViTBlock`, `ViTFrontEnd` with
`num_blocks` (its `include_norm` follows: the norm stays in the front only
when every block does), `ViTBackEnd`), with the timm
`VisionTransformer` parameter names (`patch_embed.proj`, `cls_token`,
`pos_embed`, `blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}`, `norm`), so the reference MV-Former checkpoint's
`backbone.model.*` loads strictly. A partially frozen ViT (LAYER = L below
the depth) keeps blocks 0..L-1 in the front end and blocks L.. with the
final norm in the back end (`res_finetune.blocks.{i}`, `res_finetune.norm`
in the model).

Each block runs the port's kernels on CUDA (their plain versions on CPU),
chosen at call time by the JAX package's gates (`ViTBlock.__call__`):
the attention half-block is #5 (`ops/vit_block.py`); the MLP half-block is
- `VRL_FUSED_MLP=1` (default 0): #9, the whole half-block in one launch
  (`ops/matmul.py::ln_mlp_block`);
- otherwise, by default: LN2 + fc1 + GELU as #6 (`ln_matmul_bias_act`);
- `VRL_FUSED_LN_MM=0`: LN2 as #8, then fc1 + GELU as #7 (`matmul_bias_gelu`);
- `VRL_FUSED_GELU_MM=0`: LN2 as #8, then a plain linear and GELU;
then fc2 and the residual as a plain product (as the JAX package leaves fc2
to XLA), except under #9. `VRL_APPROX_GELU=1` (bf16 only, unless
`VRL_EXACT_GELU=1`) takes the tanh GELU. After the last block the final
norm is the LayerNorm kernel (#8).

With a bf16 compute type (USE_AMP) the frozen front end keeps a bf16 copy
of its matrices and of what flax's `dtype=bf16` casts (patch embed, cls and
position embeddings, fc2's bias), made once at first use after a load; the
trainable back end casts its fp32 parameters inside autograd on every call,
so gradients reach them as flax's `dtype=bf16` Dense gives them. The LN
parameters and the kernels' biases stay fp32, as the Pallas kernels take
them. Every kernel is differentiable (`ops/plain_grad.py`), its backward
chunked over `grad_chunk` frames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import fused_layernorm
from ..ops.matmul import ln_matmul_bias_act, ln_mlp_block, matmul_bias_gelu
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


def mlp_route(dtype) -> Tuple[str, bool]:
    """(route, tanh GELU) of the MLP half-block under the JAX package's gates
    (`models/vit.py:270-359` there), read at call time: route "fused_mlp"
    (#9), "ln_mm" (#6, the default), "mm" (#8 then #7) or "plain"."""
    env = os.environ.get
    approx = (dtype == torch.bfloat16 and env("VRL_APPROX_GELU", "0") == "1"
              and env("VRL_EXACT_GELU", "0") != "1")
    if env("VRL_FUSED_MLP", "0") == "1":
        return "fused_mlp", approx
    if env("VRL_FUSED_GELU_MM", "auto") == "0":
        return "plain", approx
    if env("VRL_FUSED_LN_MM", "auto") == "0":
        return "mm", approx
    return "ln_mm", approx


class ViTBlock(nn.Module):
    """Pre-LN block: x + proj(MHA(LN1(x))), then x + fc2(GELU(fc1(LN2(x))));
    `grad_chunk` frames a chunk in the kernels' backward."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 grad_chunk: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.grad_chunk = grad_chunk
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def matrices(self, dtype):
        """(wqkv, wproj, wfc1, wfc2, bfc2) in the compute type, cast inside
        autograd (the parameters themselves when they have that type)."""
        return tuple(t.to(dtype) for t in (
            self.attn.qkv.weight, self.attn.proj.weight, self.mlp.fc1.weight,
            self.mlp.fc2.weight, self.mlp.fc2.bias))

    def forward(self, x, mats=None):
        """x (B, N, D) in the compute type; `mats` from `matrices` (default:
        cast now)."""
        wqkv, wproj, wfc1, wfc2, bfc2 = mats or self.matrices(x.dtype)
        chunk = self.grad_chunk
        x = vit_attention_block(x, self.norm1.weight, self.norm1.bias, wqkv,
                                self.attn.qkv.bias, wproj, self.attn.proj.bias,
                                self.num_heads, LN_EPS, grad_chunk=chunk)
        route, approx = mlp_route(x.dtype)
        act = "gelu_tanh" if approx else "gelu_exact"
        n2w, n2b, bfc1 = self.norm2.weight, self.norm2.bias, self.mlp.fc1.bias
        if route == "fused_mlp":
            return ln_mlp_block(x, n2w, n2b, wfc1, bfc1, wfc2, self.mlp.fc2.bias,
                                act, LN_EPS, grad_chunk=chunk)
        if route == "ln_mm":
            y = ln_matmul_bias_act(x, n2w, n2b, wfc1, bfc1, act, eps=LN_EPS,
                                   grad_chunk=chunk)
        else:
            y = fused_layernorm(x, n2w, n2b, LN_EPS, grad_chunk=chunk)
            if route == "mm":
                y = matmul_bias_gelu(y, wfc1, bfc1, approx, grad_chunk=chunk)
            else:
                y = F.gelu(F.linear(y, wfc1, bfc1.to(y.dtype)),
                           approximate="tanh" if approx else "none")
        return x + F.linear(y, wfc2, bfc2)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


def init_block(blk: ViTBlock) -> ViTBlock:
    """timm's init of a block's linear layers: trunc-normal(0.02) weights,
    zero biases."""
    for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        nn.init.trunc_normal_(lin.weight, std=0.02)
        nn.init.zeros_(lin.bias)
    return blk


class VisionTransformer(nn.Module):
    """The timm parameter tree (the reference wraps it as `backbone.model`):
    the first `num_blocks` blocks (all by default), and the final norm when
    they are all of them (else a back end owns it)."""

    def __init__(self, spec: ViTSpec, num_blocks: Optional[int] = None):
        super().__init__()
        D = spec.embed_dim
        self.patch_embed = PatchEmbed(spec.patch, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + spec.num_patches, D))
        n = spec.depth if num_blocks is None else num_blocks
        self.blocks = nn.ModuleList(ViTBlock(D, spec.num_heads, spec.mlp_ratio)
                                    for _ in range(n))
        self.norm = nn.LayerNorm(D, eps=LN_EPS) if n >= spec.depth else None
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        for blk in self.blocks:
            init_block(blk)


class ViTFrontEnd(nn.Module):
    """The frozen front: (N, 3, H, W) frames, computed in `dtype` ->
    - fully frozen (`num_blocks` None or the depth): (concat of the tapped
      block outputs (N, 1 + P, D * taps), pre-norm with the CLS token; the
      final-norm CLS feature (N, D));
    - partial (`num_blocks` = L below the depth): the raw token stream
      (N, 1 + P, D) after block L-1, for the `ViTBackEnd`, which owns the
      norm."""

    def __init__(self, spec: ViTSpec, tap_blocks: Tuple[int, ...],
                 dtype=torch.float32, num_blocks: Optional[int] = None):
        super().__init__()
        self.spec = spec
        self.tap_blocks = tuple(tap_blocks)
        self.dtype = dtype
        self.model = VisionTransformer(spec, num_blocks)
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
        if self.model.norm is None:
            return x
        normed = fused_layernorm(x, self.model.norm.weight, self.model.norm.bias,
                                 LN_EPS)
        feats = (None if not taps else taps[0] if len(taps) == 1
                 else torch.cat(taps, dim=2))
        return feats, normed[:, 0]


class ViTBackEnd(nn.Module):
    """The trainable tail: blocks `num_front_blocks`.. and the final norm.
    (N, 1 + P, D) tokens in the compute type -> (concat of the tapped block
    outputs (N, 1 + P, D * taps), `tap_blocks` global indices, or the last
    block's output when there is none; the final-norm CLS feature (N, D)).
    Parameters stay fp32 and are cast inside autograd on every call; the
    kernels' backward runs in chunks of `grad_chunk` frames."""

    def __init__(self, spec: ViTSpec, num_front_blocks: int,
                 tap_blocks: Tuple[int, ...], grad_chunk: Optional[int] = None):
        super().__init__()
        self.spec = spec
        self.tap_blocks = tuple(tap_blocks)
        D = spec.embed_dim
        self.blocks = nn.ModuleDict(
            (str(i), init_block(ViTBlock(D, spec.num_heads, spec.mlp_ratio,
                                         grad_chunk)))
            for i in range(num_front_blocks, spec.depth))
        self.norm = nn.LayerNorm(D, eps=LN_EPS)
        self.grad_chunk = grad_chunk

    def forward(self, x):
        taps = []
        for i, blk in self.blocks.items():
            x = blk(x)
            if int(i) in self.tap_blocks:
                taps.append(x)
        normed = fused_layernorm(x, self.norm.weight, self.norm.bias, LN_EPS,
                                 grad_chunk=self.grad_chunk)
        feats = (x if not taps else taps[0] if len(taps) == 1
                 else torch.cat(taps, dim=2))
        return feats, normed[:, 0]
