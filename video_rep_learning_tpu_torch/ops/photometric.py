"""The SSL photometric tail, and the crop that comes before it: the CUDA
kernels of `csrc/photometric.cu`, their plain PyTorch versions, and the
wrappers that pick between them by the device of the tensors.

Counterpart of `video_rep_learning_tpu/ops/photometric_pallas.py`:
- `crop_photometric` replaces `_crop_photometric_kernel` (RandomResizedCrop as
  rh (S, H) . x (H, W) . rw (W, S) on the uint8 canvas, then the tail);
- `photometric` replaces `_photometric_kernel` (the tail on frames that are
  already cropped).
The tail is ColorJitter (brightness, contrast, saturation, hue in a per-view
order), GaussianBlur (9 rows x 5 columns, reflect padding), grayscale,
horizontal flip and ImageNet normalisation; every flag and factor comes in
per view (`fscal`, `orders`), sampled in `ops/augment.py`.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version, which repeats the JAX kernel's math
  op for op (blur as band matrices, flip last) and is tested against it.
- The math is fp32; with `out_dtype=torch.bfloat16` only the output is
  rounded, as the JAX package's `bf16_output`. The JAX package's `bf16_math`
  (the elementwise chain in bf16, a trick for the TPU VPU's rate) is not
  carried over: the port computes the chain in fp32 on every path.

Both kernels are one design: a frame is a cluster of `CROP_STRIPS` blocks,
each owning a strip of output rows. `crop_plan` sizes the crop kernel's
strips, the chunks a strip is computed in, and the shared-memory band of
canvas rows a chunk reads, and refuses a canvas whose band cannot fit
(`fitting_plan` gives None there: `ops/augment.py` then takes the split
route). `photometric_plan` sizes the strips and chunks of the fp32 frames,
which the kernel copies row for row (no band, no taps).

The kernel takes the resample and blur matrices in compact form, computed
here from the same dense matrices the plain version multiplies by:
`resample_taps` (a row of a linear, non-antialiased resample matrix has at
most two adjacent non-zero weights) and `blur_taps` (a band matrix with the
reflect padding folded in is a 9- or 5-tap stencil with reflected indices).
`tests/test_torch_photometric.py` rebuilds the dense matrices from
both forms.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .plain_grad import use_kernel

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# fscal columns
F_JITTER, F_FB, F_FC, F_FS, F_FH, F_BLUR, F_GRAY, F_FLIP = range(8)
BLUR_ROWS, BLUR_COLS = 9, 5  # GaussianBlur kernel (5, 9): 9 taps vertically
MAX_SIZE = 512  # the kernels' shared-memory rows hold up to this
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/photometric.cu's crop_strip_kernel: blocks a frame (one cluster), the
# blur's halo rows each side of a chunk, the most rows its vertical blur
# buffers, and the dynamic shared memory a block may take on the H100
CROP_STRIPS, CROP_HALO, CROP_VROWS, CROP_SMEM = 16, BLUR_ROWS // 2, 8, 232448


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _luma(x):
    """ITU-R 601-2 luma of (..., 3, S, S) -> (..., S, S)."""
    return 0.299 * x[..., 0, :, :] + 0.587 * x[..., 1, :, :] + 0.114 * x[..., 2, :, :]


def _hue(x, f):
    """torchvision adjust_hue through HSV on (T, 3, S, S), always fp32; the
    JAX kernel's `_hue` line for line (i == 6 wraps, delta == 0 gives h 0)."""
    r, g, b = x[:, 0].clamp(0, 1), x[:, 1].clamp(0, 1), x[:, 2].clamp(0, 1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.where(delta > 0, delta, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = h / 6.0
    h = torch.where(delta > 0, h - torch.floor(h), 0.0)
    h = h + f
    h = h - torch.floor(h)
    i = torch.floor(h * 6.0)
    frac = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - frac * s)
    t = v * (1.0 - (1.0 - frac) * s)
    i = i.to(torch.int32)
    i = torch.where(i >= 6, i - 6, i)

    def pick(opts):
        out = opts[0]
        for k in range(1, 6):
            out = torch.where(i == k, opts[k], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=1)


def _jitter_op(x, op: int, fs):
    """One ColorJitter op on (T, 3, S, S); `fs` is the view's fscal row as
    fp32 0-d tensors."""
    if op == 0:
        return (x * fs[F_FB]).clamp(0, 1)
    if op == 1:
        mean = _luma(x).mean(dim=(-2, -1))[:, None, None, None]
        return (x * fs[F_FC] + mean * (1.0 - fs[F_FC])).clamp(0, 1)
    if op == 2:
        return (x * fs[F_FS] + _luma(x)[:, None] * (1.0 - fs[F_FS])).clamp(0, 1)
    return _hue(x, fs[F_FH])


def _tail_one(x, fs, order, mh, mw, out_dtype):
    """The photometric tail of one view: x (T, 3, S, S) fp32 in [0, 1]."""
    if fs[F_JITTER] > 0:
        for op in order.tolist():
            x = _jitter_op(x, op, fs)
    if fs[F_BLUR] > 0:
        x = torch.matmul(torch.matmul(mh, x), mw)
    if fs[F_GRAY] > 0:
        x = _luma(x)[:, None].expand(-1, 3, -1, -1)
    if fs[F_FLIP] > 0:
        x = torch.flip(x, dims=(-1,))
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean[:, None, None]) / std[:, None, None]).to(out_dtype)


def photometric_reference(videos, fscal, orders, mh, mw,
                          out_dtype=torch.float32):
    """videos (BV, T, 3, S, S) fp32 in [0, 1]; fscal (BV, 8) fp32 flags and
    factors; orders (BV, 4) jitter op order (0 brightness, 1 contrast,
    2 saturation, 3 hue); mh (BV, S, S) vertical and mw (BV, S, S)
    horizontal blur band matrices (blur = mh . x . mw). Returns the
    normalised (BV, T, 3, S, S) in `out_dtype`."""
    fscal = fscal.float().cpu()
    return torch.stack([
        _tail_one(videos[i].float(), fscal[i], orders[i].cpu(), mh[i], mw[i],
                  out_dtype) for i in range(videos.shape[0])])


def crop_photometric_reference(videos, rh, rw, fscal, orders, mh, mw,
                               out_dtype=torch.float32):
    """videos (BV, T, 3, H, W) uint8 (or fp32 in [0, 1]); rh (BV, S, H) and
    rw (BV, W, S) resample matrices (crop = rh . x . rw). The rest as
    `photometric_reference`."""
    out = []
    fscal = fscal.float().cpu()
    for i in range(videos.shape[0]):
        x = videos[i]
        x = x.float() * (1.0 / 255.0) if x.dtype == torch.uint8 else x.float()
        x = torch.matmul(torch.matmul(rh[i], x), rw[i])
        out.append(_tail_one(x, fscal[i], orders[i].cpu(), mh[i], mw[i],
                             out_dtype))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# compact forms of the matrices, for the kernel
# ---------------------------------------------------------------------------

def resample_taps(m):
    """(..., S, N) resample matrix -> (idx (..., S) int32, w (..., S, 2) fp32)
    with m[..., s, :] == w0 at idx, w1 at idx + 1, zero elsewhere, for a
    linear resample without antialiasing (at most two adjacent taps)."""
    n = m.shape[-1]
    first = (m != 0).to(torch.int32).argmax(dim=-1)
    idx = torch.clamp(first, max=n - 2)
    w = torch.stack([m.gather(-1, idx[..., None].long())[..., 0],
                     m.gather(-1, idx[..., None].long() + 1)[..., 0]], dim=-1)
    return idx.to(torch.int32).contiguous(), w.float().contiguous()


def blur_taps(mh, mw):
    """The stencil weights of the band matrices: (BV, 9) vertical taps read
    from an interior row of mh, (BV, 5) horizontal taps from an interior
    column of mw (`blur_band_matrix` puts w[k] at source d + k - c)."""
    cy, cx = BLUR_ROWS // 2, BLUR_COLS // 2
    return (mh[:, cy, :BLUR_ROWS].float().contiguous(),
            mw[:, :BLUR_COLS, cx].float().contiguous())


# ---------------------------------------------------------------------------
# the crop kernel's plan
# ---------------------------------------------------------------------------

class CropPlan(NamedTuple):
    """Output rows a strip (a block), rows a chunk (one pass over shared
    memory: a strip of one chunk holds its rows until the blur, which reads
    the halo from the neighbouring strips; a strip of several chunks
    recomputes each chunk's halo and sums the contrast mean in a sweep of its
    own first), the band's capacity in canvas rows and bytes a row, the rows
    the vertical blur buffers, and the block's shared memory."""

    rows: int
    chunk: int
    band_rows: int
    band_cols: int
    vrows: int
    smem: int


def pre_rows(S, rows, chunk):
    """Frame rows a block holds in shared memory: its strip's, or a chunk's
    and the blur's halo either side (clipped to the frame)."""
    return rows if chunk == rows else min(S, chunk + 2 * CROP_HALO)


def crop_smem(S, pre, band_rows, band_cols, vrows, taps=True):
    """Bytes of csrc/photometric.cu's `strip::layout`: `pre` frame rows
    (fp32, 3 channels), the band (uint8) or the vertical blur's rows (fp32),
    whichever is larger, the column and row taps (two weights and an index
    each; none for the fp32 source, `taps` False) and 512 B of sums, bounds,
    the blur's row table and the bulk copies' mbarrier, each part 16-byte
    aligned."""
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return (r16(12 * pre * S) + r16(max(3 * band_rows * band_cols, 12 * vrows * S))
            + (r16(12 * S) + r16(12 * pre) if taps else 0) + 512)


def band_rows_bound(n, H, S):
    """Canvas rows the taps of `n` consecutive output rows read, at most, for
    a linear resample of a box inside an H-row canvas to S rows: sample y
    sits at (y + 0.5) h / S + top - 0.5 with h <= H, its taps at the floor
    and the next row, so n rows span at most (n - 1) H / S + 4 rows (one
    more for fp32's rounding of h / S)."""
    return min(H, (n - 1) * H // S + 5)


def _first_fit(S, band):
    """Strips of ceil(S / CROP_STRIPS) rows, each one chunk if its rows (and
    band) fit CROP_SMEM, else the largest chunk whose rows, halo (and band)
    do; None where not even a one-row chunk fits. `band(pre)` gives the
    band's (rows, bytes a row) for `pre` staged rows, None for the fp32
    source."""
    rows = -(-S // CROP_STRIPS)
    for chunk in range(rows, 0, -1):
        pre = pre_rows(S, rows, chunk)
        band_rows, band_cols = band(pre) if band else (0, 0)
        vrows = min(CROP_VROWS, chunk)
        smem = crop_smem(S, pre, band_rows, band_cols, vrows, taps=band is not None)
        if smem <= CROP_SMEM:
            return CropPlan(rows, chunk, band_rows, band_cols, vrows, smem)
    return None


def fitting_plan(S, H, W):
    """The crop kernel's plan for S x S outputs from an H x W canvas
    (`_first_fit`, with the band of canvas rows the staged rows' taps read,
    over the canvas width rounded up to 16 bytes); None where not even a
    one-row chunk fits."""
    band_cols = -(-W // 16) * 16
    return _first_fit(S, lambda pre: (band_rows_bound(pre, H, S), band_cols))


def photometric_plan(S):
    """The photometric-only kernel's plan for S x S fp32 frames
    (`_first_fit` without a band): one chunk a strip up to S 480, chunks
    above; raises ValueError where not even a one-row chunk fits (never for
    S <= MAX_SIZE)."""
    plan = _first_fit(S, None)
    if plan is None:
        raise ValueError(f"S {S} frames do not fit the photometric kernel's shared "
                         f"memory: even a one-row chunk exceeds {CROP_SMEM} bytes")
    return plan


def crop_plan(S, H, W):
    """`fitting_plan`, raising ValueError where the canvas does not fit."""
    plan = fitting_plan(S, H, W)
    if plan is None:
        raise ValueError(f"a {H} x {W} canvas does not fit the crop kernel's shared "
                         f"memory at output size {S}: the band of even a one-row "
                         f"chunk exceeds {CROP_SMEM} bytes")
    return plan


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("photometric")
    lib.vrl_photometric.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    lib.vrl_photometric.restype = ctypes.c_int
    lib.vrl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vrl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(videos, fscal, orders, mh, mw, S, out_dtype):
    dev = videos.device
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be fp32 or bf16, got {out_dtype}")
    if not 9 <= S <= MAX_SIZE:
        raise ValueError(f"output size {S} outside the kernel's 9..{MAX_SIZE}")
    BV, T = videos.shape[:2]
    if BV > 65535 or T > 65535:
        raise ValueError(f"grid too large: {tuple(videos.shape)} (at most 65535 views "
                         "and 65535 frames a view)")
    for name, t, shape in (("fscal", fscal, (BV, 8)), ("orders", orders, (BV, 4)),
                           ("mh", mh, (BV, S, S)), ("mw", mw, (BV, S, S))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if not videos.is_contiguous():
        raise ValueError("videos must be contiguous")


def _launch(videos, src_kind, taps, fscal, orders, mh, mw, S, out_dtype, plan):
    BV, T = videos.shape[:2]
    H, W = videos.shape[3], videos.shape[4]
    wy, wx = blur_taps(mh, mw)
    fs = fscal.float().contiguous()
    order = orders.to(torch.int32).contiguous()
    out = torch.empty((BV, T, 3, S, S), dtype=out_dtype, device=videos.device)
    if T == 0:
        return out
    hi, hw, wi, ww = taps
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(videos.device):
        err = lib.vrl_photometric(
            videos.data_ptr(), ptr(hi), ptr(hw), ptr(wi), ptr(ww), fs.data_ptr(),
            order.data_ptr(), wy.data_ptr(), wx.data_ptr(), src_kind, BV, T, H,
            W, S, _DTYPE_CODES[out_dtype], out.data_ptr(),
            torch.cuda.current_stream(videos.device).cuda_stream, *plan[:5])
    if err != 0:
        raise RuntimeError("photometric kernel launch failed: "
                           + lib.vrl_cuda_error_string(err).decode())
    return out


def crop_photometric(videos, rh, rw, fscal, orders, mh, mw,
                     out_dtype=torch.float32):
    """Crop-resample + photometric tail, see `crop_photometric_reference`.
    CUDA tensors go through the kernel (uint8 frames only; rh and rw
    linear resamples of a box inside the canvas, as `ssl_matrices` builds
    them, else the kernel traps), CPU tensors through the plain version.
    `crop_photometric.launches` counts kernel launches."""
    if not use_kernel("crop_photometric", videos):
        return crop_photometric_reference(videos, rh, rw, fscal, orders, mh,
                                          mw, out_dtype)
    if videos.dim() != 5:
        raise ValueError(f"the kernel takes (BV, T, 3, H, W) uint8, got "
                         f"{tuple(videos.shape)}")
    BV, T, C, H, W = videos.shape
    S = rh.shape[1]
    if videos.dtype != torch.uint8 or C != 3 or H < 2 or W < 2:
        raise ValueError(f"the kernel takes (BV, T, 3, H >= 2, W >= 2) uint8, "
                         f"got {tuple(videos.shape)} {videos.dtype}")
    if (tuple(rh.shape) != (BV, S, H) or tuple(rw.shape) != (BV, W, S)
            or rh.device != videos.device or rw.device != videos.device):
        raise ValueError(f"rh must be {(BV, S, H)} and rw {(BV, W, S)} on "
                         f"{videos.device}, got {tuple(rh.shape)}, {tuple(rw.shape)}")
    _check(videos, fscal, orders, mh, mw, S, out_dtype)
    plan = crop_plan(S, H, W)
    taps = resample_taps(rh) + resample_taps(rw.transpose(1, 2))
    out = _launch(videos, 1, taps, fscal, orders, mh, mw, S, out_dtype, plan)
    crop_photometric.launches += 1
    return out


crop_photometric.launches = 0


def photometric(videos, fscal, orders, mh, mw, out_dtype=torch.float32):
    """The photometric tail on cropped fp32 frames, see
    `photometric_reference`. CUDA tensors go through the kernel (the crop
    kernel's strip design on the fp32 rows, planned by `photometric_plan`),
    CPU tensors through the plain version; a CUDA input that requires grad
    with grad mode on raises, as the kernel records no gradient.
    `photometric.launches` counts kernel launches."""
    if not use_kernel("photometric", videos, fscal, mh, mw):
        return photometric_reference(videos, fscal, orders, mh, mw, out_dtype)
    S = videos.shape[-1]
    if (videos.dtype != torch.float32 or videos.dim() != 5
            or videos.shape[2] != 3 or videos.shape[3] != S):
        raise ValueError(f"the kernel takes (BV, T, 3, S, S) fp32, got "
                         f"{tuple(videos.shape)} {videos.dtype}")
    _check(videos, fscal, orders, mh, mw, S, out_dtype)
    out = _launch(videos, 0, (None,) * 4, fscal, orders, mh, mw, S, out_dtype,
                  photometric_plan(S))
    photometric.launches += 1
    return out


photometric.launches = 0
