"""Video augmentation on the device: the eval preprocessing (crop, bilinear
resize, ImageNet normalisation of a (T, H, W, C) float video in [0, 1]) and
the SSL training recipe of two views per clip.

Counterpart of `video_rep_learning_tpu/ops/augment.py`: `resize_bilinear`,
`crop_resize`, `uniform_crop`, `color_normalization`, `eval_augment`, and for
training `_sample_ssl_scalars`, `sample_rrc_box`, `_rrc_matrix`,
`make_ssl_batch_augment` / `fused_ssl_batch_augment`. The JAX package
resamples with `jax.image.scale_and_translate(method="linear",
antialias=False)`; this module rebuilds that function's weight matrices
(triangle taps, renormalised where the edge drops a tap, zero where the
sample lies outside the input) and applies them as two matmuls, so the crop
is never materialised.

Training samples every random value of a step on the host from one
`torch.Generator` (`sample_ssl_batch`, `sample_supervised_batch`), apart
from applying them (`ssl_batch_augment`, `supervised_batch_augment`), so a
test can feed both packages the same values. The supervised (non-SSL)
recipe is `supervised_augment`'s: always-on brightness / contrast / hue /
saturation jitters on the whole canvas (the contrast mean over the clip's
true extent), then the RandomResizedCrop box or the true extent resampled,
the flip, and the normalisation; plain torch, as the JAX package leaves it
to XLA.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from .photometric import _hue, _luma, crop_photometric, fitting_plan, photometric

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


def crop_matrices(H: int, W: int, top, left, height, width, out_size: int,
                  device="cpu"):
    """The weights (wy (H, out), wx (W, out)) of `crop_resize`'s resample,
    the JAX package's `crop_resize` (`scale_and_translate`) to the last bit;
    the box values are fp32 scalars."""
    top, left, height, width = (_f32(v) for v in (top, left, height, width))
    scale_y, scale_x = out_size / height, out_size / width
    inv_y, inv_x = 1.0 / scale_y, 1.0 / scale_x
    return (_weight_mat(H, out_size, inv_y, (-top * scale_y) * inv_y, device),
            _weight_mat(W, out_size, inv_x, (-left * scale_x) * inv_x, device))


def crop_resize(video, top, left, height, width, out_size: int):
    """Crop the (top, left, height, width) box and resize it bilinearly to
    (out_size, out_size) in one resample; the box values are fp32 scalars."""
    _, H, W, _ = video.shape
    return _resample(video, *crop_matrices(H, W, top, left, height, width,
                                           out_size, video.device))


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


# ---------------------------------------------------------------------------
# the SSL training recipe
# ---------------------------------------------------------------------------

class AugmentParams(NamedTuple):
    """Config-derived parameters of the SSL recipe (`data_augment.py:372-413`).
    `use_amp` (the config's USE_AMP) selects bf16 output and, where the
    canvas fits, the crop fused into the photometric kernel on the uint8
    canvas, as the JAX trainer's `bf16_output` and `mxu_resample` do
    (`crop_route`); otherwise the crop is a plain matmul resample, then the
    photometric-only kernel."""

    image_size: int = 224
    strength: float = 1.0
    jitter_prob: float = 0.8
    blur_prob: float = 0.4
    gray_prob: float = 0.2
    flip_prob: float = 0.5
    use_amp: bool = False


RRC_SCALE = (0.8, 1.0)
RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)
RRC_ATTEMPTS = 10


def _uniform(gen, lo, hi, n=()):
    """fp32 U[lo, hi) on the host from `gen`."""
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    return u * (hi - lo) + lo


def sample_rrc_uniforms(gen, scale=RRC_SCALE, ratio=RRC_RATIO):
    """The random values of one RandomResizedCrop draw: (area fractions (10,),
    log aspect ratios (10,), u_i, u_j)."""
    area = _uniform(gen, scale[0], scale[1], (RRC_ATTEMPTS,))
    log_ratio = _uniform(gen, math.log(ratio[0]), math.log(ratio[1]),
                         (RRC_ATTEMPTS,))
    return area, log_ratio, _uniform(gen, 0.0, 1.0), _uniform(gen, 0.0, 1.0)


def rrc_box(uniforms, H, W, ratio=RRC_RATIO):
    """torchvision RandomResizedCrop's box (`data_augment.py:231-262`) from
    `sample_rrc_uniforms`' values, in the JAX package's fp32 arithmetic: the
    first of 10 attempts that fits wins, else the central fallback. Returns
    fp32 0-d (top, left, height, width)."""
    area_frac, log_ratio, u_i, u_j = uniforms
    H, W = _f32(H), _f32(W)
    target_area = area_frac * (H * W)
    aspect = torch.exp(log_ratio)
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= W) & (h > 0) & (h <= H)
    idx = int(valid.to(torch.int32).argmax())
    if bool(valid.any()):
        h_v, w_v = h[idx], w[idx]
        return (torch.floor(u_i * (H - h_v + 1)), torch.floor(u_j * (W - w_v + 1)),
                h_v, w_v)
    in_ratio = W / H
    if in_ratio < min(ratio):
        w_f, h_f = W, torch.round(W / min(ratio))
    elif in_ratio > max(ratio):
        w_f, h_f = torch.round(H * max(ratio)), H
    else:
        w_f, h_f = W, H
    return torch.floor((H - h_f) / 2), torch.floor((W - w_f) / 2), h_f, w_f


def sample_rrc_box(gen, H, W):
    return rrc_box(sample_rrc_uniforms(gen), H, W)


def _sample_ssl_scalars(gen, p: AugmentParams):
    """Every random value of the SSL recipe for one view except the crop box:
    (fscal (8,) fp32 = [jitter, brightness, contrast, saturation, hue, blur,
    gray, flip], order (4,) of the jitter ops, blur sigma)."""
    s = p.strength
    b, h = 0.8 * s, 0.2 * s
    fb = _uniform(gen, max(0.0, 1 - b), 1 + b)
    fc = _uniform(gen, max(0.0, 1 - b), 1 + b)
    fs = _uniform(gen, max(0.0, 1 - b), 1 + b)
    fh = _uniform(gen, -h, h)
    order = torch.randperm(4, generator=gen)
    jit = _uniform(gen, 0.0, 1.0) < p.jitter_prob
    sigma = _uniform(gen, 0.1, 2.0)
    blur = _uniform(gen, 0.0, 1.0) < p.blur_prob
    gray = _uniform(gen, 0.0, 1.0) < p.gray_prob
    flip = _uniform(gen, 0.0, 1.0) < p.flip_prob
    fscal = torch.stack([jit.float(), fb, fc, fs, fh, blur.float(),
                         gray.float(), flip.float()])
    return fscal, order, sigma


def _rrc_matrix(n_in: int, n_out: int, length, offset):
    """(n_out, n_in) resample matrix A with A @ x == scale_and_translate(x,
    scale=n_out/length, translation=-offset*n_out/length) along one axis:
    the crop of `length` from `offset`, resized to n_out."""
    length, offset = _f32(length), _f32(offset)
    scale = n_out / length
    translation = -offset * n_out / length
    inv = 1.0 / scale
    return _weight_mat(n_in, n_out, inv, translation * inv, "cpu").t()


def blur_band_matrix(size: int, ksize: int, sigma):
    """(size, size) M with M[src, dst] = the gaussian weight of source `src`
    for output `dst`, torch 'reflect' padding folded in, so a vertical blur
    is M^T x and a horizontal one x M (`photometric_pallas.py:258-273`)."""
    c = (ksize - 1) // 2
    k = torch.arange(ksize, dtype=torch.float32) - c
    w = torch.exp(-0.5 * torch.square(k / _f32(sigma)))
    w = w / w.sum()
    dst = torch.arange(size)
    src = dst[None, :] + torch.arange(ksize)[:, None] - c  # (K, size)
    src = torch.where(src < 0, -src, src)
    src = torch.where(src >= size, 2 * (size - 1) - src, src)
    onehots = (src[:, None, :] == torch.arange(size)[None, :, None]).float()
    return torch.einsum("k,ksd->sd", w, onehots)


def ssl_matrices(boxes, sigmas, H: int, W: int, S: int):
    """The per-view matrices of the recipe from its sampled boxes (BV, 4)
    (top, left, height, width) and blur sigmas (BV,): rh (BV, S, H), rw
    (BV, W, S), mh and mw (BV, S, S), all fp32 on the host."""
    rh, rw, mh, mw = [], [], [], []
    for (top, left, h, w), sigma in zip(boxes, sigmas):
        rh.append(_rrc_matrix(H, S, h, top))
        rw.append(_rrc_matrix(W, S, w, left).t())
        mh.append(blur_band_matrix(S, 9, sigma).t())
        mw.append(blur_band_matrix(S, 5, sigma))
    stack = lambda xs: torch.stack(xs).contiguous()  # noqa: E731
    return {"rh": stack(rh), "rw": stack(rw), "mh": stack(mh), "mw": stack(mw)}


def sample_ssl_batch(gen, B: int, V: int, H: int, W: int, dims,
                     params: AugmentParams):
    """All random values of one step's SSL augmentation, drawn on the host
    from `gen`, view by view (its scalars, then its crop box), and the
    matrices built from them: a dict of CPU tensors fscal (BV, 8), orders
    (BV, 4), boxes (BV, 4), sigmas (BV,) and those of `ssl_matrices`.
    `dims` (B, 2) is each clip's true (h, w) inside the (H, W) canvas, or
    None for the whole canvas."""
    fscal, orders, sigmas, boxes = [], [], [], []
    for b in range(B):
        h_true, w_true = (H, W) if dims is None else (float(dims[b][0]),
                                                      float(dims[b][1]))
        for _ in range(V):
            f, order, sigma = _sample_ssl_scalars(gen, params)
            boxes.append(torch.stack(sample_rrc_box(gen, h_true, w_true)))
            fscal.append(f)
            orders.append(order)
            sigmas.append(sigma)
    out = {"fscal": torch.stack(fscal), "orders": torch.stack(orders).to(torch.int32),
           "boxes": torch.stack(boxes), "sigmas": torch.stack(sigmas)}
    out.update(ssl_matrices(out["boxes"], out["sigmas"], H, W,
                            params.image_size))
    return out


# fp32 canvas bytes the split route converts at once: 480 frames of a
# 1080 x 1920 canvas would be ~12 GB in one piece
SPLIT_CHUNK_BYTES = 1 << 28


def crop_route(S: int, H: int, W: int, use_amp: bool) -> str:
    """Which route `ssl_batch_augment` takes for S x S outputs from an H x W
    canvas: "crop" (the crop kernel #12 on the uint8 canvas) or "split" (a
    plain matmul resample, then the photometric-only kernel #11). The JAX
    package's gate (`fused_ssl_batch_augment`, VRL_FUSED_CROP), read when
    called: 0 takes the split route, 1 (any value but 0 and auto) the crop
    kernel, which raises for a canvas it cannot take; auto (or unset) the
    crop kernel under USE_AMP where `fitting_plan` fits the canvas, else the
    split route."""
    env = os.environ.get("VRL_FUSED_CROP", "auto")
    if env == "auto":
        return "crop" if use_amp and fitting_plan(S, H, W) is not None else "split"
    return "split" if env == "0" else "crop"


def _split_crop(videos, rh, rw):
    """The split route's resample of videos (B, V, T, H, W, 3) uint8 by rh
    (BV, S, H) and rw (BV, W, S) -> (BV, T, 3, S, S) fp32 in [0, 1], a view and
    a chunk of frames at a time (SPLIT_CHUNK_BYTES of fp32 canvas); every
    frame's arithmetic is the same as in one call."""
    B, V, T, H, W, _ = videos.shape
    S = rh.shape[1]
    out = torch.empty((B * V, T, 3, S, S), dtype=torch.float32, device=videos.device)
    frames = max(1, SPLIT_CHUNK_BYTES // (12 * H * W))
    for i in range(B * V):
        b, v = divmod(i, V)
        for f0 in range(0, T, frames):
            x = videos[b, v, f0:f0 + frames].permute(0, 3, 1, 2).contiguous()
            x = x.float().div_(255.0)
            out[i, f0:f0 + frames] = torch.matmul(torch.matmul(rh[i], x), rw[i])
    return out


def ssl_batch_augment(videos, sampled, params: AugmentParams):
    """Two-view SSL augmentation of videos (B, V, T, H, W, 3) uint8 on the
    device with the values of `sample_ssl_batch` -> (B, V, T, S, S, 3)
    normalised frames, a channels-last view of channel-planar memory (the
    layout the backbone's convolutions read), bf16 under `use_amp`, else
    fp32. `crop_route` picks the route before any launch: the crop inside
    the crop+photometric kernel on the uint8 canvas, or two plain matmuls,
    then the photometric-only kernel. `ssl_batch_augment.crop_route` and
    `.split_route` count the calls each route took."""
    B, V, T, H, W, _ = videos.shape
    S = params.image_size
    dev = videos.device
    m = {k: sampled[k].to(dev, non_blocking=True)
         for k in ("rh", "rw", "fscal", "orders", "mh", "mw")}
    out_dtype = torch.bfloat16 if params.use_amp else torch.float32
    if crop_route(S, H, W, params.use_amp) == "crop":
        planar = videos.reshape(B * V, T, H, W, 3).permute(0, 1, 4, 2, 3).contiguous()
        out = crop_photometric(planar, m["rh"], m["rw"], m["fscal"],
                               m["orders"], m["mh"], m["mw"], out_dtype)
        ssl_batch_augment.crop_route += 1
    else:
        out = photometric(_split_crop(videos, m["rh"], m["rw"]), m["fscal"],
                          m["orders"], m["mh"], m["mw"], out_dtype)
        ssl_batch_augment.split_route += 1
    return out.view(B, V, T, 3, S, S).permute(0, 1, 2, 4, 5, 3)


ssl_batch_augment.crop_route = 0
ssl_batch_augment.split_route = 0


# ---------------------------------------------------------------------------
# the supervised (non-SSL) training recipe
# ---------------------------------------------------------------------------

class SupervisedParams(NamedTuple):
    """cfg.AUGMENTATION for `supervised_augment` (`data_augment.py:416-441`):
    each jitter on or off with its largest delta, RANDOM_CROP, RANDOM_FLIP."""

    image_size: int = 224
    brightness: bool = True
    brightness_max_delta: float = 0.8
    contrast: bool = True
    contrast_max_delta: float = 0.8
    hue: bool = True
    hue_max_delta: float = 0.2
    saturation: bool = True
    saturation_max_delta: float = 0.8
    random_crop: bool = True
    random_flip: bool = True

    @classmethod
    def from_cfg(cls, cfg):
        a = cfg.AUGMENTATION
        return cls(cfg.IMAGE_SIZE, bool(a.BRIGHTNESS), float(a.BRIGHTNESS_MAX_DELTA),
                   bool(a.CONTRAST), float(a.CONTRAST_MAX_DELTA), bool(a.HUE),
                   float(a.HUE_MAX_DELTA), bool(a.SATURATION),
                   float(a.SATURATION_MAX_DELTA), bool(a.RANDOM_CROP),
                   bool(a.RANDOM_FLIP))


def sample_supervised_batch(gen, B: int, H: int, W: int, dims,
                            params: SupervisedParams):
    """All random values of one step's supervised augmentation, drawn on the
    host from `gen` clip by clip: the brightness, contrast, hue and
    saturation factors (factors 1 + U[-v, v], hue U[-v, v]; each drawn
    whether its jitter is on or not), the RandomResizedCrop box against the
    clip's true (h, w) under RANDOM_CROP (else the whole true extent), the
    flip under RANDOM_FLIP. Returns CPU tensors factors (B, 4) [brightness,
    contrast, hue, saturation], boxes (B, 4) (top, left, height, width),
    flips (B,) bool, dims (B, 2), and the crop's resample matrices ry
    (B, S, H), rx (B, W, S). `dims` (B, 2) is each clip's true (h, w) inside
    the (H, W) canvas, or None for the whole canvas."""
    p = params
    S = p.image_size
    factors, boxes, flips, true_dims, ry, rx = [], [], [], [], [], []
    for b in range(B):
        h, w = (H, W) if dims is None else (float(dims[b][0]), float(dims[b][1]))
        factors.append(torch.stack([
            1.0 + _uniform(gen, -p.brightness_max_delta, p.brightness_max_delta),
            1.0 + _uniform(gen, -p.contrast_max_delta, p.contrast_max_delta),
            _uniform(gen, -p.hue_max_delta, p.hue_max_delta),
            1.0 + _uniform(gen, -p.saturation_max_delta, p.saturation_max_delta)]))
        box = (sample_rrc_box(gen, h, w) if p.random_crop
               else (_f32(0.0), _f32(0.0), _f32(h), _f32(w)))
        boxes.append(torch.stack(box))
        flips.append(bool(_uniform(gen, 0.0, 1.0) < 0.5) and p.random_flip)
        true_dims.append(torch.stack([_f32(h), _f32(w)]))
        wy, wx = crop_matrices(H, W, *box, S)
        ry.append(wy.t())
        rx.append(wx)
    return {"factors": torch.stack(factors), "boxes": torch.stack(boxes),
            "flips": torch.tensor(flips), "dims": torch.stack(true_dims),
            "ry": torch.stack(ry).contiguous(), "rx": torch.stack(rx)}


# the ops on channel-planar (..., 3, H, W) frames in [0, 1]; a factor is a
# tensor that broadcasts against the frames (a value per clip)

def adjust_brightness(x, f):
    return (x * f).clamp(0.0, 1.0)


def adjust_contrast(x, f, extent=None):
    """Blend with the mean luma of each frame over `extent` (a 0 / 1 mask
    broadcasting to (..., H, W): the clip's true extent inside its canvas),
    or over the whole frame."""
    gray = _luma(x)
    if extent is None:
        mean = gray.mean(dim=(-2, -1), keepdim=True)
    else:
        mean = ((gray * extent).sum(dim=(-2, -1), keepdim=True)
                / extent.sum(dim=(-2, -1), keepdim=True).clamp(min=1.0))
    return (x * f + mean[..., None, :, :] * (1.0 - f)).clamp(0.0, 1.0)


def adjust_saturation(x, f):
    return (x * f + _luma(x)[..., None, :, :] * (1.0 - f)).clamp(0.0, 1.0)


def adjust_hue(x, f):
    """torchvision adjust_hue through HSV (`ops/photometric.py::_hue`, the
    JAX package's `adjust_hue` line for line); `f` has x's dimensions."""
    lead, tail = x.shape[:-3], x.shape[-3:]
    shift = torch.broadcast_to(f[..., 0, :, :], lead + (1, 1)).reshape(-1, 1, 1)
    return _hue(x.reshape((-1,) + tail), shift).view(x.shape)


def hflip(x):
    return torch.flip(x, dims=(-1,))


def supervised_batch_augment(videos, sampled, params: SupervisedParams):
    """The supervised recipe on videos (B, T, H, W, 3) uint8 on the device
    with the values of `sample_supervised_batch` -> (B, T, S, S, 3) fp32
    normalised frames, a channels-last view of channel-planar memory: the
    jitters that are on in the JAX order (brightness, contrast, hue,
    saturation) on the whole canvas, the crop box resampled to S x S (the
    JAX recipe's last resize, S x S to S x S, is the identity), the flip,
    the normalisation."""
    B, T, H, W, _ = videos.shape
    dev = videos.device
    p = params
    m = {k: sampled[k].to(dev, non_blocking=True)
         for k in ("factors", "dims", "ry", "rx", "flips")}
    f = m["factors"].view(B, 1, 1, 1, 1, 4)
    x = videos.permute(0, 1, 4, 2, 3).float().div_(255.0)  # (B, T, 3, H, W)
    if p.brightness:
        x = adjust_brightness(x, f[..., 0])
    if p.contrast:
        dims = m["dims"].view(B, 1, 1, 2)
        ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        extent = ((ys < dims[..., 0]) & (xs < dims[..., 1])).float()
        x = adjust_contrast(x, f[..., 1], extent[:, None])
    if p.hue:
        x = adjust_hue(x, f[..., 2])
    if p.saturation:
        x = adjust_saturation(x, f[..., 3])
    x = torch.matmul(torch.matmul(m["ry"][:, None, None], x), m["rx"][:, None, None])
    x = torch.where(m["flips"].view(B, 1, 1, 1, 1), hflip(x), x)
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(3, 1, 1)
    return ((x - mean) / std).permute(0, 1, 3, 4, 2)
