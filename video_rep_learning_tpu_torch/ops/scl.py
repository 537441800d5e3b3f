"""The fused SCL loss, forward and backward: the CUDA kernels' four passes,
their plain PyTorch versions, the wrappers that pick between them by the
device of the tensors, and the autograd Function over them.

Counterpart of `video_rep_learning_tpu/ops/scl_pallas.py`: `_pair_terms`,
`_gauss_tile` (with its `transposed` orientation), `_tile_terms`, the passes
`_rowsum_kernel`, `_loss_kernel`, `_srow_kernel`, `_grad_kernel`, the padding
rules `_block_layout` / `_pad_inputs`, `_build_meta` and `scl_loss_fused`.
The kernels are `csrc/scl.cu`. With N = B*V*T frame embeddings e (N, C),
l = e e^T / tau and the pair terms of `algos/scl.py`:
  pass 1 `scl_rowsum`    negsum_i = sum_j w_ij exp(l_ij), possum_i = sum_j pos_ij
  pass 2 `scl_loss_rows` sum_j KL(label_ij || exp(l_ij) / negsum_i) * mask
  pass 3 `scl_srow`      S_i = sum_j im_ij label_ij c_ij, c = r / (r + 1e-6),
                         r = exp(l_ij) / negsum_i
  pass 4 `scl_grad`      de_i = sum_j (G_ij + G_ji) e_j, with
                         G_ij = w_ij r_ij S_i - im_ij label_ij c_ij
and loss = sum(pass 2) / sum(masks), dL/de = (g / (mask_sum tau)) pass 4.
No (N, N) buffer exists on the kernels' path; the forward keeps e, the
per-frame metadata and the row sums, O(N C).

One departure from the Pallas passes: the backward's labels are
pos / possum with NaN -> 0, as the forward's are, where `_srow_kernel` and
`_grad_kernel` multiply by 1 / possum. When a row's gaussian positives all
but underflow (possum subnormal, e.g. a frame whose timeline maps into the
other view's masked tail), 1 / possum overflows to inf on hardware that
keeps subnormals (the H100 without fast math; the TPU and XLA's CPU flush
them to 0), and the product gives inf or NaN; the division keeps the
gradient finite and equal to the plain composition's autograd.

Per-frame metadata is an (8, N) array: rows step, len, mask, sample, view,
is_real (and two zero rows). Inputs are padded to a multiple of the kernels'
64-row tile with all-zero columns, is_real = 0, which take part in no pair.

- A CUDA tensor launches the kernel or raises: there is no fallback.
- A CPU tensor takes the plain version (`*_reference`), the same per-row
  outputs computed over the whole (N, N) matrix at once.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

TILE = 64  # csrc/scl.cu's rows a block and columns a tile
C_MULTIPLE, MAX_C = 16, 128  # the embedding widths the kernels take


# -- per-pair terms (`_pair_terms`, `_gauss_tile`, `_tile_terms`) -----------

def pair_terms(meta_i, meta_j, *, single, noself):
    """(weight, im_raw, im_eff, cross_eff) of every (i, j): negative
    weights, the raw and padding-free pair masks, and the cross-view block of
    the same sample; padding (is_real 0) takes part in nothing."""
    _, _, m_i, samp_i, view_i, real_i = meta_i[:6]
    _, _, m_j, samp_j, view_j, real_j = meta_j[:6]
    im_raw = m_i[:, None] * m_j[None, :]
    same_sample = samp_i[:, None] == samp_j[None, :]
    same_view = same_sample & (view_i[:, None] == view_j[None, :])
    cross = same_sample & ~same_view
    weight = torch.ones_like(im_raw)
    if single:
        weight = torch.where(same_sample, weight, 0.0)
    if noself:
        weight = torch.where(same_view, 0.0, weight)
    weight = torch.where(im_raw == 0, 1e-6, weight)
    pad = (real_i[:, None] * real_j[None, :]) == 0
    weight = torch.where(pad, 0.0, weight)
    im_eff = torch.where(pad, 0.0, im_raw)
    return weight, im_raw, im_eff, cross & ~pad


def gauss_tile(meta_i, meta_j, im_raw, cross_eff, *, label_varience,
               transposed=False):
    """Gaussian positives. dist_ij uses row i's timeline; `transposed` gives
    dist_ji laid out as (i, j), the orientation of the G^T term."""
    step_i, len_i = meta_i[0], meta_i[1]
    step_j, len_j = meta_j[0], meta_j[1]
    if not transposed:
        dist = (step_i[:, None] / len_i[:, None] * len_j[None, :]
                - step_j[None, :]).abs()
    else:
        dist = (step_j[None, :] / len_j[None, :] * len_i[:, None]
                - step_i[:, None]).abs()
    dist = torch.where(im_raw == 0, 1e6, dist)
    return torch.where(cross_eff,
                       torch.exp(-torch.square(dist) / (2.0 * label_varience)), 0.0)


def tile_terms(e_i, e_j, meta_i, meta_j, *, temperature, label_varience,
               single, noself):
    """(exp_logits, weight, pos_gauss, im_eff, cross_eff) of every pair."""
    logits = (e_i @ e_j.t()) / temperature
    weight, im_raw, im_eff, cross = pair_terms(meta_i, meta_j, single=single,
                                               noself=noself)
    pos = gauss_tile(meta_i, meta_j, im_raw, cross,
                     label_varience=label_varience)
    return torch.exp(logits), weight, pos, im_eff, cross


def work_pairs(meta, *, single, noself):
    """The pairs the passes need, as two (Np, Np) bool masks: `pairs`, those
    with a negative weight or a positive label (passes 1 and 4), and
    `positives`, the cross-view pairs of two unmasked real frames, the only
    ones whose label, and so whose loss and S terms, can be nonzero (passes
    2 and 3); `ops/bounds.py`'s `scl_fused` counts work over them."""
    weight, _, im, cross = pair_terms(meta, meta, single=single, noself=noself)
    positives = cross & (im > 0)
    return (weight != 0) | positives, positives


def _safe_div(a, b):
    out = a / b
    return torch.where(torch.isnan(out), 0.0, out)


def _inv_or_zero(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


# -- the passes' plain versions ----------------------------------------------

def rowsum_reference(e, meta, *, temperature, label_varience, single, noself):
    """Pass 1: (Np, 2) = (negsum, possum) a row."""
    el, w, pos, _, _ = tile_terms(e, e, meta, meta, temperature=temperature,
                                  label_varience=label_varience, single=single,
                                  noself=noself)
    return torch.stack([(w * el).sum(1), pos.sum(1)], dim=1)


def loss_rows_reference(e, meta, rows, *, temperature, label_varience, single,
                        noself):
    """Pass 2: (Np,) sum_j of the masked KL term, from pass 1's rows."""
    el, _, pos, im, cross = tile_terms(e, e, meta, meta, temperature=temperature,
                                       label_varience=label_varience,
                                       single=single, noself=noself)
    negsum, possum = rows[:, 0:1], rows[:, 1:2]
    label = torch.where(cross, _safe_div(pos, possum), 0.0)
    log_input = torch.log(_safe_div(el, negsum) + 1e-6)
    xlogx = torch.where(label > 0, label * torch.log(torch.where(label > 0, label, 1.0)),
                        0.0)
    # guard 0 * inf on padded rows (negsum == 0 -> log_input == inf)
    return torch.where(im > 0, xlogx - label * log_input, 0.0).sum(1)


def srow_reference(e, meta, rows, *, temperature, label_varience, single, noself):
    """Pass 3: (Np,) S_i = sum_j im_ij label_ij c_ij."""
    el, _, pos, im, cross = tile_terms(e, e, meta, meta, temperature=temperature,
                                       label_varience=label_varience,
                                       single=single, noself=noself)
    r = el * _inv_or_zero(rows[:, 0:1])
    c = r / (r + 1e-6)
    label = torch.where(cross, _safe_div(pos, rows[:, 1:2]), 0.0)
    return (im * label * c).sum(1)


def grad_reference(e, meta, rows, s, *, temperature, label_varience, single,
                   noself):
    """Pass 4: (Np, C) (G + G^T) e, unscaled by g / (mask_sum tau)."""
    el = torch.exp((e @ e.t()) / temperature)
    weight, im_raw, im, cross = pair_terms(meta, meta, single=single,
                                           noself=noself)
    rinv, possum = _inv_or_zero(rows[:, 0]), rows[:, 1]
    # term 1, both orientations (weight and exp are symmetric)
    g = weight * el * ((rinv * s)[:, None] + (rinv * s)[None, :])
    # term 2, IJ orientation
    pos_ij = gauss_tile(meta, meta, im_raw, cross, label_varience=label_varience)
    r_ij = el * rinv[:, None]
    g = g - im * _safe_div(pos_ij, possum[:, None]) * (r_ij / (r_ij + 1e-6))
    # term 2, JI orientation laid out as (I, J)
    pos_ji = gauss_tile(meta, meta, im_raw, cross, label_varience=label_varience,
                        transposed=True)
    r_ji = el * rinv[None, :]
    g = g - im * _safe_div(pos_ji, possum[None, :]) * (r_ji / (r_ji + 1e-6))
    return g @ e


# -- the wrappers --------------------------------------------------------------

def check_width(C):
    """Raise for an embedding width the kernels do not take (on every device,
    so the fused route refuses on the CPU what it would refuse on the card)."""
    if C % C_MULTIPLE or not C_MULTIPLE <= C <= MAX_C:
        raise ValueError(f"the fused SCL kernels take an embedding width C with "
                         f"C % {C_MULTIPLE} == 0 and {C_MULTIPLE} <= C <= "
                         f"{MAX_C}; got C={C}")


def _check_inputs(e, meta, rows=None, s=None):
    """e (Np, C) and meta (8, Np), fp32 and contiguous on one device, Np a
    multiple of TILE; rows (Np, 2) and s (Np,) likewise where given."""
    if e.dim() != 2:
        raise ValueError(f"e must be (Np, C), got {tuple(e.shape)}")
    Np, C = e.shape
    check_width(C)
    want = [("e", e, (Np, C)), ("meta", meta, (8, Np))]
    if rows is not None:
        want.append(("rows", rows, (Np, 2)))
    if s is not None:
        want.append(("s", s, (Np,)))
    for name, t, shape in want:
        if (t.shape != shape or t.dtype != torch.float32 or t.device != e.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 {shape} tensor on "
                             f"{e.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if e.device.type == "cuda" and (Np == 0 or Np % TILE):
        raise ValueError(f"the kernels take Np % {TILE} == 0 rows (pad with "
                         f"pad_inputs), got Np={Np}")
    if e.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused SCL passes run on cuda or cpu, not {e.device}")
    return Np, C


def _kernel_args(temperature, label_varience, single, noself):
    return (float(temperature), float(label_varience), int(bool(single)),
            int(bool(noself)))


# each pass: its plain version, its output's shape, and the csrc/scl.cu
# entry point that launches it with its trailing int arguments
_PASSES = {"rowsum": (rowsum_reference, lambda Np, C: (Np, 2), "vrl_scl_rows", (0,)),
           "loss": (loss_rows_reference, lambda Np, C: (Np,), "vrl_scl_rows", (1,)),
           "srow": (srow_reference, lambda Np, C: (Np,), "vrl_scl_rows", (2,)),
           "grad": (grad_reference, lambda Np, C: (Np, C), "vrl_scl_grad", ())}


def _run_pass(wrapper, name, e, meta, rows=None, s=None, **params):
    """Pass `name` on e's device: the plain version on a CPU tensor, else the
    kernel, counted on `wrapper.launches`. `vrl_scl_rows` takes the pointers
    e, meta, rows (None for pass 1), out; `vrl_scl_grad` e, meta, rows, s,
    de; both then Np, C, tau, var, single, noself, the pass's ints, stream."""
    Np, C = _check_inputs(e, meta, rows, s)
    reference, out_shape, symbol, extra = _PASSES[name]
    if e.device.type == "cpu":
        return reference(*(t for t in (e, meta, rows, s) if t is not None), **params)
    ins = (e, meta, rows) + ((s,) if name == "grad" else ())
    out = torch.empty(out_shape(Np, C), dtype=torch.float32, device=e.device)
    fn = cuda_build.kernel_fn("scl", symbol, (ctypes.c_void_p,) * (len(ins) + 1)
                              + (ctypes.c_int,) * 2 + (ctypes.c_float,) * 2
                              + (ctypes.c_int,) * (2 + len(extra)) + (ctypes.c_void_p,))
    with torch.cuda.device(e.device):
        err = fn(*(None if t is None else t.data_ptr() for t in ins), out.data_ptr(),
                 Np, C, *_kernel_args(**params), *extra,
                 torch.cuda.current_stream(e.device).cuda_stream)
    cuda_build.check_launch("scl", err)
    wrapper.launches += 1
    return out


def scl_rowsum(e, meta, **params):
    """Pass 1 (`_rowsum_kernel`): (Np, 2) negsum, possum. CUDA tensors go
    through the kernel, CPU tensors through `rowsum_reference`; `params` are
    temperature, label_varience, single, noself. `scl_rowsum.launches` counts
    kernel launches."""
    return _run_pass(scl_rowsum, "rowsum", e, meta, **params)


def scl_loss_rows(e, meta, rows, **params):
    """Pass 2 (`_loss_kernel`): (Np,) KL row sums from pass 1's rows, else as
    `scl_rowsum` with `loss_rows_reference`."""
    return _run_pass(scl_loss_rows, "loss", e, meta, rows, **params)


def scl_srow(e, meta, rows, **params):
    """Pass 3 (`_srow_kernel`): (Np,) S row sums, else as `scl_rowsum` with
    `srow_reference`."""
    return _run_pass(scl_srow, "srow", e, meta, rows, **params)


def scl_grad(e, meta, rows, s, **params):
    """Pass 4 (`_grad_kernel`): (Np, C) unscaled gradient, else as
    `scl_rowsum` with `grad_reference`."""
    return _run_pass(scl_grad, "grad", e, meta, rows, s, **params)


for _fn in (scl_rowsum, scl_loss_rows, scl_srow, scl_grad):
    _fn.launches = 0


# -- padding, metadata and the autograd Function -----------------------------

def block_layout(N, block=TILE):
    """`_block_layout`: N rows padded to Np, a multiple of the row tile."""
    return -(-N // block) * block


def pad_inputs(e, meta, Np):
    """`_pad_inputs`: zero rows of e and zero columns of meta up to Np; the
    padding's is_real is 0, so it counts for nothing."""
    N = e.shape[0]
    if Np > N:
        e = torch.nn.functional.pad(e, (0, 0, 0, Np - N))
        meta = torch.nn.functional.pad(meta, (0, Np - N))
    return e.contiguous(), meta.contiguous()


def build_meta(seq_lens, steps, masks):
    """`_build_meta`: the (8, N) fp32 per-frame rows step, len, mask,
    sample, view, is_real (and two zero rows) of (B, V, T) frames."""
    B, V, T = steps.shape
    N = B * V * T
    dev = steps.device
    idx = torch.arange(N, device=dev)
    return torch.stack([
        steps.reshape(N).float(),
        seq_lens.reshape(B, V, 1).expand(B, V, T).reshape(N).float(),
        masks.reshape(N).float(),
        (idx // (V * T)).float(),
        ((idx // T) % V).float(),
        torch.ones(N, device=dev),
        torch.zeros(N, device=dev),
        torch.zeros(N, device=dev),
    ])


def sample_inputs(B, T, seed, V=2, C=128, device="cpu"):
    """Seeded (embs, seq_lens, steps, masks) of (B, V, T) frames to hold the
    kernels against their plain versions: unit-norm embeddings, steps inside
    lengths of 1.2-3x T, a masked tail in one view and a masked frame inside
    another."""
    g = torch.Generator().manual_seed(seed)
    e = torch.randn(B, V, T, C, generator=g)
    e = e / e.norm(dim=-1, keepdim=True)
    lens = torch.randint(int(1.2 * T), 3 * T, (B, V), generator=g).float()
    steps = torch.sort(torch.rand(B, V, T, generator=g) * lens[..., None], -1)[0].floor()
    masks = torch.ones(B, V, T)
    masks[-1, 0, -T // 8:] = 0
    masks[0, -1, T // 2] = 0
    return [t.to(device) for t in (e, lens, steps, masks)]


def _flags(negative_type):
    return dict(single="single" in negative_type, noself="noself" in negative_type)


class SCLFused(torch.autograd.Function):
    """`scl_loss_fused`'s custom vjp: the forward runs passes 1 and 2 and
    keeps e, meta, the row sums and mask_sum (O(N C)); the backward runs
    passes 3 and 4 and scales by g / (mask_sum tau)."""

    @staticmethod
    def forward(ctx, embs, seq_lens, steps, masks, temperature, label_varience,
                negative_type):
        B, V, T, C = embs.shape
        check_width(C)
        e = embs.detach().reshape(B * V * T, C).float()
        meta = build_meta(seq_lens, steps, masks)
        e, meta = pad_inputs(e, meta, block_layout(B * V * T))
        params = dict(temperature=temperature, label_varience=label_varience,
                      **_flags(negative_type))
        rows = scl_rowsum(e, meta, **params)
        loss_rows = scl_loss_rows(e, meta, rows, **params)
        mask_sum = (meta[2] * meta[5]).sum()
        ctx.save_for_backward(e, meta, rows, mask_sum)
        ctx.params = params
        ctx.shape, ctx.dtype = embs.shape, embs.dtype
        return loss_rows.sum() / mask_sum

    @staticmethod
    def backward(ctx, g):
        e, meta, rows, mask_sum = ctx.saved_tensors
        p = ctx.params
        s = scl_srow(e, meta, rows, **p)
        de = scl_grad(e, meta, rows, s, **p) * (g / (mask_sum * p["temperature"]))
        B, V, T, C = ctx.shape
        dembs = de[:B * V * T].reshape(B, V, T, C).to(ctx.dtype)
        return dembs, None, None, None, None, None, None


def scl_loss_fused(embs, seq_lens, steps, masks, temperature, label_varience,
                   negative_type):
    """Fused SCL loss: embs (B, V, T, C) -> 0-d fp32; the same math as
    `algos.scl.scl_sequence_loss` with gauss positives, differentiable in
    embs; no (N, N) buffer on CUDA."""
    return SCLFused.apply(embs, seq_lens, steps, masks, temperature,
                          label_varience, negative_type)
