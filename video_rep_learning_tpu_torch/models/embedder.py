"""Temporal fusion head and the small output heads.

Counterpart of `video_rep_learning_tpu/models/embedder.py`
(`TransformerEmbModel`, `Classifier`, `MLPHead`), with the reference
checkpoint's parameter names. `MLPHead` keeps the reference quirk: its hidden
width is MODEL.PROJECTION_SIZE and it outputs EMBEDDING_SIZE. The conv and
vanilla embedders come with the TCC/TCN slice.
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from .layers import BN_EPS, BatchNorm1d, Encoder, FCBNStack, PositionalEncoder


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
