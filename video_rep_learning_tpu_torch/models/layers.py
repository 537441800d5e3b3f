"""Transformer primitives for the temporal fusion heads.

Counterpart of `video_rep_learning_tpu/models/layers.py`. Module and
parameter names follow the reference `TransformerModel` state-dict layout
(`models/import_torch.py::convert_to_carl_state_dict`), so a reference
checkpoint loads with `strict=True`:
`enc_layers.N.{res_layer0,res_layer1}.norm`, `self_att.linear_{Q2d,K2d,V2d,d2Q}`,
`feed_forward.fc{1,2}`, and FC+BN stacks as `[Dropout, Linear, BatchNorm1d,
ReLU]` groups.

Self-attention with a key mask goes through `ops.attention.mha_with_flash`
on every length: the hand-written kernel on CUDA, its plain version on CPU.

Across processes, `convert_sync_batchnorm` makes the BatchNorms that run on
batch statistics normalise over the global batch (the reference's
SyncBatchNorm, `train.py:283`; what the JAX package's BN gets from a
batch sharded over the mesh).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_with_flash
from ..parallel.mesh import world

# Large-negative mask fill of `scaled_dot_attention`; finite so bf16 rows
# never turn NaN, and equal to -inf after the softmax for any row with one
# unmasked key.
NEG_INF = -1e9

# flax.linen.LayerNorm's default epsilon, which the JAX package uses.
LN_EPS = 1e-6
# torch BatchNorm1d's, which the JAX package's TorchBatchNorm copies.
BN_EPS = 1e-5


def scaled_dot_attention(q, k, v, mask=None, disjoint: bool = False,
                         return_attn: bool = False):
    """(B, H, Sq, d) x (B, H, Sk, d) attention with a mask broadcastable to
    (B, 1, Sq|1, Sk), nonzero = keep. The path for masks that are not a plain
    per-key mask, and for LSTP's few-query pooling. `disjoint` gates the
    attention after the softmax so each key keeps only its argmax query's
    weight; `return_attn` also returns the (B, H, Sq, Sk) attention."""
    d_k = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d_k)
    if mask is not None:
        scores = torch.where(mask == 0, NEG_INF, scores)
    attn = torch.softmax(scores, dim=-1)
    if disjoint:
        owner = F.one_hot(attn.argmax(dim=2), attn.shape[2])  # (B, H, Sk, Sq)
        attn = attn * owner.transpose(-1, -2).to(attn.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype).float(), v.float())
    out = out.to(v.dtype)
    return (out, attn) if return_attn else out


class MultiheadedAttention(nn.Module):
    """MHA with independent Q/K/V model widths."""

    def __init__(self, d_model_Q: int, d_model_K: int, d_model_V: int, H: int,
                 d_model: Optional[int] = None, d_out: Optional[int] = None,
                 dout_p: float = 0.0):
        super().__init__()
        self.d_model = d_model or d_model_Q
        self.d_out = d_out or d_model_Q
        if self.d_model % H:
            raise ValueError(f"d_model {self.d_model} not divisible by {H} heads")
        self.H = H
        self.d_k = self.d_model // H
        self.linear_Q2d = nn.Linear(d_model_Q, self.d_model)
        self.linear_K2d = nn.Linear(d_model_K, self.d_model)
        self.linear_V2d = nn.Linear(d_model_V, self.d_model)
        self.linear_d2Q = nn.Linear(self.d_model, self.d_out)
        self.dropout = nn.Dropout(dout_p)

    def _heads(self, x):
        B = x.shape[0]
        return x.view(B, -1, self.H, self.d_k).transpose(1, 2).contiguous()

    def forward(self, Q, K, V, mask=None):
        """mask: (B, 1, Sk) key mask, or (B, Sq, Sk); nonzero = keep."""
        B, Sq, _ = Q.shape
        q = self._heads(self.linear_Q2d(Q))
        k = self._heads(self.linear_K2d(K))
        v = self._heads(self.linear_V2d(V))
        if mask is None or (mask.dim() == 3 and mask.shape[1] == 1):
            out = mha_with_flash(q, k, v, None if mask is None else mask[:, 0])
        else:
            out = scaled_dot_attention(q, k, v, mask[:, None])
        # the reference applies dropout to the attention output
        out = self.dropout(out)
        out = out.transpose(1, 2).reshape(B, Sq, self.d_model)
        return self.linear_d2Q(out)


def _sincos(pos, d_model: int):
    """Sin on even feature indices, cos on odd ones (the reference's
    convention), for positions `pos` (..., S) -> (..., S, d_model)."""
    dev = pos.device
    even = torch.arange(0, d_model, 2, device=dev)
    odd = torch.arange(1, d_model, 2, device=dev)
    mat = torch.zeros(pos.shape + (d_model,), dtype=torch.float32, device=dev)
    mat[..., even] = torch.sin(pos[..., None] / torch.pow(10000.0, even / d_model))
    mat[..., odd] = torch.cos(pos[..., None] / torch.pow(10000.0, odd / d_model))
    return mat


def sincos_embedding(seq_len: int, d_model: int,
                     train_len: Optional[int] = None, device=None):
    """(1, seq_len, d_model) sin/cos positions. With `train_len`, positions
    are linspace(0, train_len - 1, seq_len), so sequences of another length
    map into the trained range. The linspace is `jnp.linspace`'s fp32 formula
    (stop * i / (n - 1), exact endpoint)."""
    if train_len is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    elif seq_len == 1:
        pos = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        div = seq_len - 1
        stop = torch.tensor(float(train_len - 1), dtype=torch.float32,
                            device=device)
        step = torch.arange(div, dtype=torch.float32, device=device) / div
        pos = torch.cat([stop * step, stop[None]])
    return _sincos(pos, d_model)[None]


def sincos_embedding_dynamic(S: int, d_model: int, train_len: int, true_n,
                             device=None):
    """Positions for a length-S buffer whose true length is `true_n`: arange
    when true_n == train_len, else linspace(0, train_len - 1, true_n).
    Entries at indices >= true_n are arbitrary (those frames are masked).
    `true_n` is a scalar, giving (1, S, d), or a (B,) vector, giving
    (B, S, d)."""
    idx = torch.arange(S, dtype=torch.float32, device=device)
    if not isinstance(true_n, torch.Tensor) and np.ndim(true_n) == 0:
        # a host scalar: the same fp32 arithmetic, with no copy to the device
        tn = float(true_n)
        pos = idx if tn == train_len else (
            idx * (train_len - 1) / max(tn - 1.0, 1.0))
        return _sincos(pos[None], d_model)
    tn = torch.as_tensor(true_n, dtype=torch.float32, device=device)
    if tn.dim() == 1:
        tn = tn[:, None]
    interp = idx[None] * (train_len - 1) / torch.clamp(tn - 1.0, min=1.0)
    pos = torch.where(tn == train_len, idx[None], interp)
    return _sincos(pos, d_model)


class PositionalEncoder(nn.Module):
    """Adds (interpolated) sin/cos positions, then dropout. `true_len` is the
    true sequence length when x is padded past it."""

    def __init__(self, d_model: int, dout_p: float, seq_len: int = 3660):
        super().__init__()
        self.d_model = d_model
        self.seq_len = seq_len
        self.dropout = nn.Dropout(dout_p)

    def forward(self, x, true_len=None):
        S = x.shape[1]
        if true_len is not None:
            pe = sincos_embedding_dynamic(S, x.shape[2], self.seq_len, true_len,
                                          device=x.device)
        else:
            train_len = self.seq_len if S != self.seq_len else None
            pe = sincos_embedding(S, x.shape[2], train_len, device=x.device)
        return self.dropout(x + pe.to(x.dtype))


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dout_p: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.dropout = nn.Dropout(dout_p)

    def forward(self, x):
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class ResidualConnection(nn.Module):
    """Pre-LN residual: x + Dropout(sublayer(LayerNorm(x)))."""

    def __init__(self, size: int, dout_p: float):
        super().__init__()
        self.norm = nn.LayerNorm(size, eps=LN_EPS)
        self.dropout = nn.Dropout(dout_p)

    def forward(self, x, sublayer):
        return x + self.dropout(sublayer(self.norm(x)))


class EncoderLayer(nn.Module):
    """x + Dropout(SelfAtt(LN(x))), then x + Dropout(FF(LN(x))); the feed
    forward's inner dropout is 0, as in the reference."""

    def __init__(self, d_model: int, dout_p: float, H: int = 8,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.res_layer0 = ResidualConnection(d_model, dout_p)
        self.res_layer1 = ResidualConnection(d_model, dout_p)
        self.self_att = MultiheadedAttention(d_model, d_model, d_model, H)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dout_p=0.0)

    def forward(self, x, src_mask=None):
        x = self.res_layer0(x, lambda t: self.self_att(t, t, t, src_mask))
        return self.res_layer1(x, self.feed_forward)


class Encoder(nn.Module):
    def __init__(self, d_model: int, dout_p: float, H: int, d_ff: int, N: int):
        super().__init__()
        self.enc_layers = nn.ModuleList(
            EncoderLayer(d_model, dout_p, H, d_ff) for _ in range(N))

    def forward(self, x, src_mask=None):
        for layer in self.enc_layers:
            x = layer(x, src_mask)
        return x


class _FlaxRunningStats:
    """Train-mode BatchNorm whose running variance follows flax's update (the
    JAX package's `TorchBatchNorm`): var_run <- (1 - m) var_run + m var_batch
    with the biased batch variance, where torch uses the unbiased one. The
    normalisation itself is torch's (biased batch statistics, as in flax)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        m = self.momentum
        # torch's update goes into copies (the op saves them for backward)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # torch added m * var * n / (n - 1): rescale it
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    pass


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of x (N, C, ...) over the batch of every rank,
    in fp32. The forward all-reduces [sum x, sum x^2, count] a channel and
    takes flax's statistics, mean = E[x] and the biased var = max(E[x^2] -
    E[x]^2, 0) (the JAX package's BatchNorm over a global batch); the
    backward all-reduces [sum dy, sum dy x_hat], which the gradient through
    the global statistics needs. The weight and bias gradients stay local:
    DDP averages them. Returns (y in x's dtype, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, C) + (1,) * (x.dim() - 2)
        xf = x.float()
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), float(x.numel() // C))])
        torch.distributed.all_reduce(stats)
        n = stats[2 * C:]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, C) + (1,) * (x.dim() - 2)
        gyf = gy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sums = torch.cat([gyf.sum(dims), (gyf * xhat).sum(dims)])
        g_bias, g_weight = sums[:C].clone(), sums[C:].clone()
        torch.distributed.all_reduce(sums)
        gx = (invstd * weight).view(shape) * (
            gyf - (sums[:C] / n).view(shape) - xhat * (sums[C:] / n).view(shape))
        return gx.to(x.dtype), g_weight, g_bias, None


class _GlobalStats:
    """Train-mode statistics over every rank's batch (`_GlobalBatchNorm`),
    running statistics by flax's rule with the global mean and biased
    variance. In eval mode, or with one process, the module's own path: a
    world-1 run is bit-identical to a run without a process group."""

    def forward(self, x):
        if not self.training or world()[0] == 1:
            return super().forward(x)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class SyncBatchNorm1d(_GlobalStats, BatchNorm1d):
    pass


class SyncBatchNorm2d(_GlobalStats, BatchNorm2d):
    pass


class SyncBatchNorm3d(_GlobalStats, BatchNorm3d):
    pass


_SYNCED = {BatchNorm1d: SyncBatchNorm1d, BatchNorm2d: SyncBatchNorm2d,
           BatchNorm3d: SyncBatchNorm3d}


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Swap the class of every BatchNorm that runs on batch statistics for
    its synced counterpart, in place (the same parameters and buffers): the
    FC+BN stacks, the projection head's, `ConvEmbed`'s BatchNorm3d and a
    trainable ResNet tail's. The frozen trunk (`backbone.*`) keeps its
    eval-mode BN (`CARLModel.train`, also under TRAIN_BASE train_all) and
    stays as it is."""
    for name, module in model.named_modules():
        sync = _SYNCED.get(type(module))
        if sync is not None and not name.startswith("backbone."):
            module.__class__ = sync
    return model


class FCBNStack(nn.Sequential):
    """[Dropout -> Linear -> BatchNorm1d -> ReLU] per width, so the Linear of
    group g is child 4g+1 and its BatchNorm child 4g+2 (reference layout)."""

    def __init__(self, in_channels: int, channels, drop_rate: float):
        layers = []
        for ch in channels:
            layers += [nn.Dropout(drop_rate), nn.Linear(in_channels, ch),
                       BatchNorm1d(ch, eps=BN_EPS), nn.ReLU()]
            in_channels = ch
        super().__init__(*layers)
