"""MV-Former heads: Learnable Spatial Token Pooling (LSTP) and the
multi-entity temporal fusion embedder.

Counterpart of `video_rep_learning_tpu/models/mvformer.py` (`LSTPCrossAtt`,
`LearnableTokenPooling`, `FWBPooling`, `MultiEntityTransformerEmbModel`),
every option included, with the reference checkpoint's parameter names
(`pooling.cross_att.{linear_K2d, linear_V2d, Q_s, Q_s_b, in2dynQ}`,
`pooling.lin_conv`, `fc_layers.{4g+1, 4g+2}`, `video_emb`,
`video_encoder.enc_layers.*`, `lin_final`, `embedding_layer`).

LSTP attention is per frame (the keys are one frame's spatial tokens), so it
runs as one batched single-head attention over all frames. `SMART_LN_KEYS`
L2-normalises the keys (not a LayerNorm), as the reference does. The casts
follow the JAX module under USE_AMP: the static queries take the tokens'
type, the linear layers compute in fp32, and with VAL_PASS the values (and
so the pooled tokens) stay in the tokens' type.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Encoder, FCBNStack, PositionalEncoder, scaled_dot_attention


def _uniform_fan_in(t, fan_in):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(t, -bound, bound)


class LSTPCrossAtt(nn.Module):
    """Single-head cross-attention pooling with learned static and/or
    dynamic queries. tokens (F, S, C_in), dyn_in (F, C_dyn) -> (pooled
    (F, nq, C_out), attention (F, nq, S))."""

    def __init__(self, in_channels: int, num_static: int, num_dynamic: int,
                 d_model: int, d_dyn_in: Optional[int] = None,
                 val_pass: bool = False, disjoint: bool = False,
                 ln_keys: bool = False, dyn_ctrl: str = "separate"):
        super().__init__()
        if num_static == 0 and num_dynamic == 0:
            raise ValueError("need static and/or dynamic tokens")
        if dyn_ctrl not in ("separate", "first", "average"):
            raise ValueError(f"DYNAMIC_CTRL {dyn_ctrl}")
        self.num_static, self.num_dynamic, self.d_model = (num_static,
                                                           num_dynamic, d_model)
        self.val_pass, self.disjoint, self.ln_keys = val_pass, disjoint, ln_keys
        self.dyn_ctrl = dyn_ctrl
        self.linear_K2d = nn.Linear(in_channels, d_model)
        if not val_pass:
            self.linear_V2d = nn.Linear(in_channels, d_model)
        if num_static > 0:
            self.Q_s = nn.Parameter(torch.empty(1, num_static, d_model))
            self.Q_s_b = nn.Parameter(torch.empty(d_model))
            for p in (self.Q_s, self.Q_s_b):
                _uniform_fan_in(p, num_static * d_model)
        if num_dynamic > 0:
            self.in2dynQ = nn.Linear(d_dyn_in, d_model * num_dynamic)

    def forward(self, tokens, dyn_in=None, frames_per_video: Optional[int] = None):
        Fr = tokens.shape[0]
        K = self.linear_K2d(tokens.float())
        V = tokens if self.val_pass else self.linear_V2d(tokens.float())
        queries = []
        if self.num_static > 0:
            q = (self.Q_s + self.Q_s_b).to(tokens.dtype).float()
            queries.append(q.expand(Fr, -1, -1))
        if self.num_dynamic > 0:
            if dyn_in is None:
                raise ValueError("dynamic queries need the CLS features")
            if self.dyn_ctrl != "separate":
                if frames_per_video is None or Fr % frames_per_video:
                    raise ValueError(f"{Fr} frames are not whole videos of "
                                     f"{frames_per_video}")
                grouped = dyn_in.view(Fr // frames_per_video, frames_per_video, -1)
                per_video = (grouped[:, 0] if self.dyn_ctrl == "first"
                             else grouped.float().mean(1).to(dyn_in.dtype))
                dyn_in = per_video.repeat_interleave(frames_per_video, dim=0)
            q_d = self.in2dynQ(dyn_in.float())
            queries.append(q_d.view(Fr, self.num_dynamic, self.d_model))
        Q = torch.cat(queries, dim=1)
        if self.ln_keys:
            K = F.normalize(K, dim=-1, eps=1e-12)
        out, attn = scaled_dot_attention(Q[:, None], K[:, None], V[:, None],
                                         disjoint=self.disjoint, return_attn=True)
        return out[:, 0], attn[:, 0]


class LearnableTokenPooling(nn.Module):
    """The LSTP wrapper: each frame's token grid -> nst + ndyn entity tokens."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.cross_att = LSTPCrossAtt(*args, **kwargs)

    def forward(self, tokens, dyn_in=None, frames_per_video=None):
        return self.cross_att(tokens, dyn_in, frames_per_video)


class FWBPooling(nn.Module):
    """Fixed-width baseline: a Linear from the CLS features to spc * ntok
    channels, read as (spc, ntok), then token-major."""

    def __init__(self, d_dyn_in: int, num_tokens: int, d_model: int):
        super().__init__()
        self.num_tokens = num_tokens
        self.lin_conv = nn.Linear(d_dyn_in, d_model * num_tokens)

    def forward(self, tokens, dyn_in=None, frames_per_video=None):
        x = self.lin_conv(dyn_in.float())
        return x.view(x.shape[0], -1, self.num_tokens).transpose(1, 2), None


class MultiEntityTransformerEmbModel(nn.Module):
    """Backbone feature grids (BV, T, h, w, C) and CLS features (BV*T, C_cls)
    -> (BV, T, embedding_size) fp32."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 embedding_size: int, fc_channels: Tuple[int, ...],
                 drop_rate: float, num_layers: int, num_heads: int, d_ff: int,
                 train_num_frames: int, num_static: int, num_dynamic: int,
                 pool_channels: int, d_dyn_in: Optional[int] = None,
                 one_hot_pos: str = "none", smart_final: str = "max",
                 fixed_width_baseline: bool = False, val_pass: bool = False,
                 disjoint: bool = False, ln_keys: bool = False,
                 dyn_ctrl: str = "separate"):
        super().__init__()
        if one_hot_pos not in ("none", "pool", "enc"):
            raise ValueError(f"SMART_ONE_HOT {one_hot_pos}")
        if smart_final not in ("max", "one", "avg", "lin"):
            raise ValueError(f"SMART_FINAL {smart_final}")
        ntok = num_static + num_dynamic
        self.ntok, self.one_hot_pos, self.smart_final = ntok, one_hot_pos, smart_final
        if fixed_width_baseline:
            self.pooling = FWBPooling(d_dyn_in, ntok, pool_channels)
        else:
            self.pooling = LearnableTokenPooling(
                in_channels, num_static, num_dynamic, pool_channels, d_dyn_in,
                val_pass, disjoint, ln_keys, dyn_ctrl)
        width = pool_channels + (ntok if one_hot_pos == "pool" else 0)
        self.fc_layers = FCBNStack(width, fc_channels, drop_rate)
        if fc_channels:
            width = fc_channels[-1]
        # the reference takes num_static here, not ntok
        hidden = hidden_channels - (num_static if one_hot_pos == "enc" else 0)
        self.video_emb = nn.Linear(width, hidden)
        self.video_pos_enc = PositionalEncoder(hidden, drop_rate,
                                               seq_len=train_num_frames)
        d_enc = hidden + (ntok if one_hot_pos == "enc" else 0)
        self.video_encoder = (Encoder(d_enc, drop_rate, num_heads, d_ff, num_layers)
                              if num_layers > 0 else None)
        if smart_final == "lin":
            self.lin_final = nn.Linear(d_enc * ntok, d_enc)
        self.embedding_layer = nn.Linear(d_enc, embedding_size)

    def forward(self, x, video_masks=None, cls_emb=None, true_len=None):
        BV, T = x.shape[:2]
        ntok = self.ntok
        tokens = x.reshape(BV * T, -1, x.shape[-1])
        x, _ = self.pooling(tokens, cls_emb, frames_per_video=T)
        if self.one_hot_pos == "pool":
            eye = torch.eye(ntok, dtype=x.dtype, device=x.device)
            x = torch.cat([x, eye.expand(x.shape[0], -1, -1)], dim=2)
        x = self.video_emb(self.fc_layers(x.reshape(BV * T * ntok, -1).float()))

        # (BV*T*ntok, hid) -> per-token sequences (BV*ntok, T, hid)
        x = x.view(BV, T, ntok, -1).transpose(1, 2).reshape(BV * ntok, T, -1)
        if isinstance(true_len, torch.Tensor) and true_len.dim() == 1:
            true_len = true_len.repeat_interleave(ntok)  # batch-major
        x = self.video_pos_enc(x, true_len=true_len).view(BV, ntok, T, -1)
        if self.one_hot_pos == "enc":
            eye = torch.eye(ntok, dtype=x.dtype, device=x.device)
            x = torch.cat([x, eye[None, :, None, :].expand(BV, ntok, T, ntok)], dim=3)
        x = x.reshape(BV, ntok * T, -1)
        if self.video_encoder is not None:
            vm = video_masks
            if vm is not None:  # (BV, 1, T) -> (BV, 1, ntok*T), token-major
                vm = vm[:, :, None, :].expand(BV, 1, ntok, T).reshape(BV, 1, ntok * T)
            x = self.video_encoder(x, src_mask=vm)
        x = x.view(BV, ntok, T, -1)

        if self.smart_final == "max":
            x = x.amax(dim=1)
        elif self.smart_final == "one":
            x = x[:, 0]
        elif self.smart_final == "avg":
            x = x.mean(dim=1)
        else:
            x = self.lin_final(x.transpose(1, 2).reshape(BV, T, -1))
        return self.embedding_layer(x)
