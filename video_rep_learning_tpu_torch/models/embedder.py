"""Temporal fusion heads and the small output heads.

Counterpart of `video_rep_learning_tpu/models/embedder.py`
(`TransformerEmbModel`, `ConvEmbed` and `VanillaEmbed` in one `ConvEmbed`,
`Classifier`, `MLPHead`), with the reference checkpoint's parameter names
where it has them; the conv and vanilla embedders keep the JAX package's
module names (`conv{i}`, `convbn{i}`, `fc{i}`, `embedding_layer`). `MLPHead` keeps the
reference quirk: its hidden width is MODEL.PROJECTION_SIZE and it outputs
EMBEDDING_SIZE.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

from .layers import (BN_EPS, BatchNorm1d, BatchNorm3d, Encoder, FCBNStack,
                     PositionalEncoder)


class TransformerEmbModel(nn.Module):
    """Spatial pool -> FC+BN stack -> linear -> positions -> temporal
    transformer -> embedding. Input (B, T, C, h, w) backbone features, output
    (B, T, embedding_size) fp32."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 embedding_size: int, fc_channels: Tuple[int, ...],
                 drop_rate: float, flatten_method: str, num_layers: int,
                 num_heads: int, d_ff: int, train_num_frames: int):
        super().__init__()
        if flatten_method not in ("max_pool", "avg_pool"):
            raise ValueError(flatten_method)
        self.flatten_method = flatten_method
        self.fc_layers = FCBNStack(in_channels, fc_channels, drop_rate)
        fc_out = fc_channels[-1] if fc_channels else in_channels
        self.video_emb = nn.Linear(fc_out, hidden_channels)
        self.video_pos_enc = PositionalEncoder(hidden_channels, drop_rate,
                                               seq_len=train_num_frames)
        self.video_encoder = Encoder(hidden_channels, drop_rate, num_heads,
                                     d_ff, num_layers) if num_layers > 0 else None
        self.embedding_layer = nn.Linear(hidden_channels, embedding_size)

    def forward(self, x, video_masks=None, true_len=None):
        B, T = x.shape[:2]
        x = x.flatten(0, 1)
        if self.flatten_method == "max_pool":
            x = x.amax(dim=(2, 3))
        else:
            x = x.mean(dim=(2, 3))
        # the head computes in fp32 whatever the backbone's type, as the flax
        # Dense layers promote bf16 features against fp32 params
        x = self.video_emb(self.fc_layers(x.float()))
        x = self.video_pos_enc(x.view(B, T, -1), true_len=true_len)
        if self.video_encoder is not None:
            x = self.video_encoder(x, src_mask=video_masks)
        return self.embedding_layer(x)


class ConvEmbed(nn.Module):
    """The context embedder of TCC / TCN: (B, T * num_contexts, C, h, w)
    features, each step's context frames consecutive as the sampler lays
    them out, -> (B, T, embedding_size). For each (channels, k, tpad) of
    `conv_params` Conv3d over (context, h, w) (k^3, padding (tpad, 0, 0)) ->
    BatchNorm3d -> ReLU; then the max over (context, h, w); for each FC
    width Dropout -> Linear -> ReLU; then `embedding_layer`. With no conv
    layers it is the JAX package's `VanillaEmbed`. It computes in fp32, as
    the flax layers promote bf16 features against fp32 parameters."""

    def __init__(self, in_channels: int, embedding_size: int,
                 conv_params: Tuple[Tuple[int, int, int], ...],
                 fc_channels: Tuple[int, ...], drop_rate: float,
                 num_contexts: int):
        super().__init__()
        self.num_contexts = num_contexts
        self.num_conv, self.num_fc = len(conv_params), len(fc_channels)
        for i, (ch, k, tpad) in enumerate(conv_params):
            setattr(self, f"conv{i}", nn.Conv3d(in_channels, ch, k,
                                                padding=(tpad, 0, 0)))
            setattr(self, f"convbn{i}", BatchNorm3d(ch, eps=BN_EPS))
            in_channels = ch
        self.dropout = nn.Dropout(drop_rate)
        for i, ch in enumerate(fc_channels):
            setattr(self, f"fc{i}", nn.Linear(in_channels, ch))
            in_channels = ch
        self.embedding_layer = nn.Linear(in_channels, embedding_size)

    def forward(self, x, num_frames: int):
        B, total = x.shape[:2]
        if total != num_frames * self.num_contexts:
            raise ValueError(f"{total} frames are not {num_frames} steps x "
                             f"{self.num_contexts} contexts")
        x = x.reshape((B * num_frames, self.num_contexts) + x.shape[2:])
        x = x.float().transpose(1, 2)  # (B * T, C, ctx, h, w)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"convbn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.amax(dim=(2, 3, 4))
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i}")(self.dropout(x)))
        return self.embedding_layer(x).view(B, num_frames, -1)


class Classifier(nn.Module):
    """Per-frame linear classifier: `fc_layers` = [Dropout, Linear]."""

    def __init__(self, in_channels: int, num_classes: int, drop_rate: float):
        super().__init__()
        self.fc_layers = nn.Sequential(nn.Dropout(drop_rate),
                                       nn.Linear(in_channels, num_classes))

    def forward(self, x):
        return self.fc_layers(x)


class MLPHead(nn.Module):
    """SimCLR projection: `net` = [Linear(emb -> PROJECTION_SIZE), BN, ReLU,
    Linear(-> emb)]."""

    def __init__(self, embedding_size: int, projection_hidden: int):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(embedding_size, projection_hidden),
            BatchNorm1d(projection_hidden, eps=BN_EPS),
            nn.ReLU(),
            nn.Linear(projection_hidden, embedding_size))

    def forward(self, x):
        b, l, c = x.shape
        return self.net(x.reshape(-1, c)).view(b, l, -1)
