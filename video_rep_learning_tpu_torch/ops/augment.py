"""Eval-time video preprocessing on the device: crop, bilinear resize and
ImageNet normalisation of a (T, H, W, C) float video in [0, 1].

Counterpart of the eval part of `video_rep_learning_tpu/ops/augment.py`
(`resize_bilinear`, `crop_resize`, `uniform_crop`, `color_normalization`,
`eval_augment`). The JAX package resamples with
`jax.image.scale_and_translate(method="linear", antialias=False)`; this module
rebuilds that function's weight matrices (triangle taps, renormalised where
the edge drops a tap, zero where the sample lies outside the input) and
applies them as two matmuls, so the crop is never materialised. The
training-time augmentations come with the training slice.
"""

from __future__ import annotations

import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _f32(x):
    """An fp32 0-d CPU tensor: box arithmetic stays in fp32 like the JAX
    package's, and a CPU scalar enters CUDA ops without a device sync."""
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def _weight_mat(in_size: int, out_size: int, inv_scale, shift, device):
    """`jax.image.scale.compute_weight_mat` for the linear kernel without
    antialiasing: (in_size, out_size) fp32 weights for output samples at
    input position (i + 0.5) * inv_scale - shift - 0.5. Every step is an fp32
    op in the JAX order, so the weights match it to the last bit."""
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - shift - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _resample(video, wy, wx):
    """(T, H, W, C) x wy (H, oh) x wx (W, ow) -> (T, oh, ow, C)."""
    x = video.permute(0, 3, 1, 2)  # (T, C, H, W) view
    x = torch.matmul(wy.t(), x)    # (T, C, oh, W)
    x = torch.matmul(x, wx)        # (T, C, oh, ow)
    return x.permute(0, 2, 3, 1)


def resize_bilinear(video, size: int):
    """`jax.image.resize(method="bilinear", antialias=False)` of a
    (T, H, W, C) video to (T, size, size, C)."""
    _, H, W, _ = video.shape
    # jax.image.resize takes the scale as a Python float: its inverse is
    # computed in float64, then rounded once to fp32
    return _resample(video, _weight_mat(H, size, 1.0 / (size / H), 0.0, video.device),
                     _weight_mat(W, size, 1.0 / (size / W), 0.0, video.device))


def crop_resize(video, top, left, height, width, out_size: int):
    """Crop the (top, left, height, width) box and resize it bilinearly to
    (out_size, out_size) in one resample; the box values are fp32 scalars."""
    _, H, W, _ = video.shape
    dev = video.device
    top, left, height, width = (_f32(v) for v in (top, left, height, width))
    scale_y, scale_x = out_size / height, out_size / width
    inv_y, inv_x = 1.0 / scale_y, 1.0 / scale_x
    wy = _weight_mat(H, out_size, inv_y, (-top * scale_y) * inv_y, dev)
    wx = _weight_mat(W, out_size, inv_x, (-left * scale_x) * inv_x, dev)
    return _resample(video, wy, wx)


def uniform_crop(video, size: int, spatial_idx: int = 1):
    """Deterministic left/center/right (or top/center/bottom) crop."""
    _, H, W, _ = video.shape
    y = int(math.ceil((H - size) / 2))
    x = int(math.ceil((W - size) / 2))
    if H > W:
        if spatial_idx == 0:
            y = 0
        elif spatial_idx == 2:
            y = H - size
    else:
        if spatial_idx == 0:
            x = 0
        elif spatial_idx == 2:
            x = W - size
    return video[:, y:y + size, x:x + size, :]


def color_normalization(video, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    mean = torch.as_tensor(mean, dtype=video.dtype, device=video.device)
    std = torch.as_tensor(std, dtype=video.dtype, device=video.device)
    return (video - mean) / std


def eval_augment(video, image_size: int = 224, dims=None):
    """Center crop -> resize -> normalise. With `dims` = (h, w), the true
    extent inside a padded canvas, the centred crop box is computed on it and
    crop + resize compose into one resample."""
    if dims is None:
        size = min(video.shape[1], video.shape[2], image_size)
        video = uniform_crop(video, size, spatial_idx=1)
        video = resize_bilinear(video, image_size)
        return color_normalization(video)
    h, w = (_f32(d) for d in dims)
    ch = torch.clamp(h, max=image_size)
    cw = torch.clamp(w, max=image_size)
    top = torch.ceil((h - ch) / 2)
    left = torch.ceil((w - cw) / 2)
    video = crop_resize(video, top, left, ch, cw, image_size)
    return color_normalization(video)
