"""On-device, box-aware augmentation (``fdtpu/data/augment.py``).

The reference augments on the host through Albumentations
(``datamodule.py:105-125``); fdtpu and the port do it on the card, inside
the train step:

==========================  =====  ===========================================
reference op                p      here
==========================  =====  ===========================================
RandomResizedCrop           0.2    two batched contractions with closed-form
                                   linear-resize weights (``_crop_weight_mat``)
HorizontalFlip              0.5    a reverse of the width axis
RandomBrightnessContrast    0.2    ``x * alpha + beta``
Rotate(20)                  0.2    three-shear rotation, hand-written kernels
                                   (``kernels/rotate.py``), ``rotate=True``
GaussNoise(var 10..400)     0.2    additive normal noise
GlassBlur                   0.2    5x5 Gaussian blur, sigma 0.7
MotionBlur                  0.2    7x7 line kernel
==========================  =====  ===========================================

Boxes are clipped, filtered by ``min_area=10`` and rounded; images end in
[0, 1].

:func:`augment_batch_fast` has fdtpu's two branches:

* ``B < 16``: per-sample Bernoulli gates (the reference's distribution,
  fdtpu's ``augment_sample``), then gated rotation of the whole batch.
  Float32 output.
* ``B >= 16``: exact-k subsets. Exactly ``round(p B)`` rows are cropped,
  rotated, noised, glass-blurred and motion-blurred; the three photometric
  subsets are disjoint, and with ``positional_crop`` they are contiguous row
  ranges (valid for shuffled feeds) and odd rows flip (fdtpu's
  ``positional_flip``). The batch stays bfloat16 end to end. With
  ``fused_photometric`` it is fdtpu's ``FDTPU_PALLAS_AUGMENT=1`` route
  instead: float32 end to end, the flip a Bernoulli draw applied first, then
  the whole photometric chain on every image in one launch of the K5 kernel
  (``kernels/photometric.py``), its noise from per-plane seeds.

Sampling is split from applying: ``sample_*`` draws every random choice
from one ``torch.Generator`` on the batch's device into a draws object, and
``apply_*`` takes the draws as arguments, so tests can hand it fdtpu's
draws. On the default routes the noise field is one of the draws: its
bits cannot match JAX's generators. On the fused route the draws are the
per-plane seeds, and the field they set matches fdtpu's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from fdtpu_torch.kernels.photometric import photometric_batch
from fdtpu_torch.kernels.rotate import rotate_batch, rotate_boxes

MIN_AREA = 10.0  # datamodule.py:121

P_CROP, P_FLIP, P_BC, P_NOISE, P_GLASS, P_MOTION = 0.2, 0.5, 0.2, 0.2, 0.2, 0.2
P_ROTATE, ROTATE_LIMIT_DEG = 0.2, 20.0


# -- filters ---------------------------------------------------------------------


def _gaussian_kernel5(sigma: float = 0.7, device=None) -> torch.Tensor:
    r = torch.arange(-2, 3, dtype=torch.float32, device=device)
    k = torch.exp(-(r**2) / (2 * sigma**2))
    k = k / k.sum()
    return torch.outer(k, k)


def _motion_kernel7(angle: torch.Tensor) -> torch.Tensor:
    """``(K, 7, 7)`` line kernels at ``angle`` ``(K,)`` radians."""
    r = torch.arange(-3, 4, dtype=torch.float32, device=angle.device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    dx, dy = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    dist = (-dy * xx + dx * yy).abs()
    along = (dx * xx + dy * yy).abs()
    k = (1.0 - dist).clamp_min(0.0) * (along <= 3.0)
    return k / k.sum(dim=(1, 2), keepdim=True).clamp_min(1e-6)


def _depthwise_filter_batch(imgs: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Filter each ``(H, W, C)`` image of ``(K, H, W, C)`` with its own
    ``(kh, kw)`` kernel (``kernels`` ``(K, kh, kw)``, or one shared) on every
    channel, zero padding to the same size, as one grouped convolution."""
    kb, h, w, c = imgs.shape
    lhs = imgs.permute(0, 3, 1, 2).reshape(1, kb * c, h, w)
    if kernels.dim() == 2:
        kernels = kernels.expand(kb, *kernels.shape)
    rhs = kernels.repeat_interleave(c, dim=0)[:, None].to(imgs.dtype)
    out = F.conv2d(lhs, rhs, padding=kernels.shape[-1] // 2, groups=kb * c)
    return out.reshape(kb, c, h, w).permute(0, 2, 3, 1)


# -- crop --------------------------------------------------------------------------


def _crop_weight_mat(size: int, offset: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """``(K, in, out)`` linear-resize weights resampling each window
    ``[offset, offset + span)`` back to ``size`` samples; fdtpu's closed
    form of ``jax.image``'s triangle-kernel weights (crops always
    upsample, so clamping the sample position replaces the border
    renormalization)."""
    ar = torch.arange(size, dtype=torch.float32, device=offset.device)
    pos = offset[:, None] + (ar + 0.5) * (span / size)[:, None] - 0.5
    pos = pos.clamp(0.0, float(size - 1))
    x = (pos[:, None, :] - ar[None, :, None]).abs()
    return (1.0 - x).clamp_min(0.0)


def _crop_window(u: torch.Tensor, h: int, w: int, do_crop: torch.Tensor | None = None):
    """RandomResizedCrop windows ``(cx, cy, cw, ch)`` from uniforms
    ``u`` ``(K, 4)`` (scale (0.08, 1), ratio (3/4, 4/3)); the identity
    window ``(0, 0, w, h)`` where ``do_crop`` is False."""
    area = (0.08 + u[:, 0] * (1.0 - 0.08)) * (w * h)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    ratio = torch.exp(lo + u[:, 1] * (hi - lo))
    cw = torch.sqrt(area * ratio).clamp(8.0, w)
    ch = torch.sqrt(area / ratio).clamp(8.0, h)
    cx = u[:, 2] * (w - cw)
    cy = u[:, 3] * (h - ch)
    if do_crop is not None:
        cw = torch.where(do_crop, cw, float(w))
        ch = torch.where(do_crop, ch, float(h))
        cx = torch.where(do_crop, cx, 0.0)
        cy = torch.where(do_crop, cy, 0.0)
    return cx, cy, cw, ch


def _apply_crop(imgs, boxes, masks, cx, cy, cw, ch):
    """Resample each ``(K, H, W, C)`` image's window to full size (weights
    built in float32 and cast to the image dtype) and transform its padded
    ``(K, N, 5)`` boxes; ``fdtpu.data.augment._apply_crop`` over a batch."""
    h, w = imgs.shape[1], imgs.shape[2]
    sy, sx = (h / ch)[:, None], (w / cw)[:, None]
    wy = _crop_weight_mat(h, cy, ch).to(imgs.dtype)
    wx = _crop_weight_mat(w, cx, cw).to(imgs.dtype)
    out = torch.einsum("khwc,kho->kowc", imgs, wy)
    out = torch.einsum("kowc,kwp->kopc", out, wx)
    bx = (boxes[..., 1] - cx[:, None]) * sx
    by = (boxes[..., 2] - cy[:, None]) * sy
    bw = boxes[..., 3] * sx
    bh = boxes[..., 4] * sy
    x0, y0 = bx.clamp(0, w), by.clamp(0, h)
    x1, y1 = (bx + bw).clamp(0, w), (by + bh).clamp(0, h)
    bw, bh = x1 - x0, y1 - y0
    boxes = torch.stack([boxes[..., 0], x0, y0, bw, bh], dim=-1)
    masks = masks & (bw * bh >= MIN_AREA) & (bw > 0) & (bh > 0)
    return out, boxes, masks


def _round_coords(boxes: torch.Tensor) -> torch.Tensor:
    """Round x, y, w, h half to even (``dataset.py:88``)."""
    return torch.cat([boxes[..., :1], torch.round(boxes[..., 1:])], dim=-1)


def _flip_boxes(boxes: torch.Tensor, do_flip: torch.Tensor, w: int) -> torch.Tensor:
    x0 = torch.where(do_flip[:, None] > 0.5, w - boxes[..., 1] - boxes[..., 3], boxes[..., 1])
    return torch.cat([boxes[..., :1], x0[..., None], boxes[..., 2:]], dim=-1)


def _uniform(gen, shape, lo, hi, device):
    return lo + torch.rand(shape, generator=gen, device=device) * (hi - lo)


def _bernoulli(gen, p, n, device):
    return torch.rand((n,), generator=gen, device=device) < p


def _rotation_angles(gen, n, device):
    limit = math.radians(ROTATE_LIMIT_DEG)
    return _uniform(gen, (n,), -limit, limit, device)


# -- B < 16: per-sample gates ------------------------------------------------------------


@dataclasses.dataclass
class SampleDraws:
    """Every random choice of the per-sample path, one row per image.

    ``crop_window``: ``(cx, cy, cw, ch)``, the identity where the crop gate
    did not fire. The photometric fields are ``(B,)`` float32: ``flip``,
    ``noise_gate``, ``glass`` and ``motion`` are 0/1 gates, ``alpha`` and
    ``beta`` are 1 and 0 where brightness/contrast did not fire, ``sigma``
    is drawn for every image, ``motion_angle`` is in radians. ``noise`` is
    ``(B, H, W, 3)`` bfloat16 standard normal. ``rotate_gate`` ``(B,)``
    bool and ``angles`` ``(B,)`` (0 where the gate is off) are None unless
    the batch rotates.
    """

    crop_window: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    flip: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    noise_gate: torch.Tensor
    sigma: torch.Tensor
    glass: torch.Tensor
    motion: torch.Tensor
    motion_angle: torch.Tensor
    noise: torch.Tensor
    rotate_gate: torch.Tensor | None = None
    angles: torch.Tensor | None = None


def sample_per_sample(gen: torch.Generator, b: int, h: int, w: int, device, rotate: bool) -> SampleDraws:
    """Draw :class:`SampleDraws` for a ``B``-image batch from ``gen``."""
    do_crop = _bernoulli(gen, P_CROP, b, device)
    window = _crop_window(torch.rand((b, 4), generator=gen, device=device), h, w, do_crop)
    do_bc = _bernoulli(gen, P_BC, b, device)
    alpha = torch.where(do_bc, 1.0 + _uniform(gen, (b,), -0.2, 0.2, device), 1.0)
    beta = torch.where(do_bc, _uniform(gen, (b,), -0.2, 0.2, device) * 255.0, 0.0)
    draws = SampleDraws(
        crop_window=window,
        flip=_bernoulli(gen, P_FLIP, b, device).float(),
        alpha=alpha,
        beta=beta,
        noise_gate=_bernoulli(gen, P_NOISE, b, device).float(),
        sigma=torch.sqrt(_uniform(gen, (b,), 10.0, 400.0, device)),
        glass=_bernoulli(gen, P_GLASS, b, device).float(),
        motion=_bernoulli(gen, P_MOTION, b, device).float(),
        motion_angle=_uniform(gen, (b,), 0.0, math.pi, device),
        noise=torch.randn((b, h, w, 3), generator=gen, device=device, dtype=torch.bfloat16),
    )
    if rotate:
        draws.rotate_gate = _bernoulli(gen, P_ROTATE, b, device)
        draws.angles = torch.where(draws.rotate_gate, _rotation_angles(gen, b, device), 0.0)
    return draws


def _col(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)[:, None, None, None]


def apply_per_sample(imgs, boxes, masks, d: SampleDraws):
    """The per-sample path (``fdtpu.data.augment.augment_sample`` over the
    batch, then gated rotation): crop in float32, flip and photometric in
    bfloat16, output float32 in [0, 1]."""
    w = imgs.shape[2]
    img, boxes, masks = _apply_crop(imgs.float(), boxes, masks, *d.crop_window)
    img = img.to(torch.bfloat16)
    bf = img.dtype

    img = torch.where(_col(d.flip, torch.float32) > 0.5, img.flip(2), img)
    boxes = _flip_boxes(boxes, d.flip, w)
    img = img * _col(d.alpha, bf) + _col(d.beta, bf)
    img = img + _col(d.noise_gate, bf) * (d.noise * _col(d.sigma, bf))
    blurred = _depthwise_filter_batch(img, _gaussian_kernel5(device=img.device))
    img = torch.where(_col(d.glass, torch.float32) > 0.5, blurred, img)
    motion = _depthwise_filter_batch(img, _motion_kernel7(d.motion_angle))
    img = torch.where(_col(d.motion, torch.float32) > 0.5, motion, img)
    img = img.float().clamp(0.0, 255.0) / 255.0
    boxes = _round_coords(boxes)

    if d.rotate_gate is None:
        return img, boxes, masks
    rot_i = rotate_batch(img * 255.0, d.angles) / 255.0
    rot_b, rot_m = rotate_boxes(boxes, masks, d.angles, w)
    rot_b = _round_coords(rot_b)
    # ungated images keep their boxes untouched: the min-area filter must
    # not fire at angle 0
    gate = d.rotate_gate
    img = torch.where(gate[:, None, None, None], rot_i, img)
    boxes = torch.where(gate[:, None, None], rot_b, boxes)
    masks = torch.where(gate[:, None], rot_m, masks)
    return img, boxes, masks


# -- B >= 16: exact-k subsets ---------------------------------------------------------------


def _photometric_counts(b: int) -> tuple[int, int, int]:
    """Exact-k subset sizes of noise, glass and motion, each from its own p
    (at least 3 each for the exact-k path's B >= 16)."""
    return round(P_NOISE * b), round(P_GLASS * b), round(P_MOTION * b)


@dataclasses.dataclass
class ExactKDraws:
    """Every random choice of the exact-k path.

    ``crop_rows`` ``(k,)`` long and ``crop_window`` ``(cx, cy, cw, ch)``
    ``(k,)`` each, ``k = round(P_CROP B)``. ``scalars`` ``(B, 8)`` float32,
    fdtpu's table: ``[flip, alpha, beta, sigma, glass, motion, motion_bin,
    0]`` (sigma, glass and motion are 0 off their subsets). ``sels``: the
    noise, glass and motion rows, disjoint. ``photo_start``: the first row
    of the contiguous photometric block (positional subsets), or None.
    ``positional_flip``: odd rows flip. ``noise``: ``(n_noise, H, W, 3)``
    bfloat16 standard normal for the noise rows, or None on the fused route,
    which draws ``seeds`` ``(3 B,)`` int32 in [0, 2^31 - 1) instead, one per
    image channel plane. ``rotate_rows`` ``(rk,)`` and ``angles`` ``(rk,)``
    are None unless the batch rotates.
    """

    crop_rows: torch.Tensor
    crop_window: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    scalars: torch.Tensor
    sels: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    noise: torch.Tensor | None
    photo_start: int | None = None
    positional_flip: bool = False
    rotate_rows: torch.Tensor | None = None
    angles: torch.Tensor | None = None
    seeds: torch.Tensor | None = None


def sample_exact_k(
    gen: torch.Generator, b: int, h: int, w: int, device, rotate: bool, positional_crop: bool,
    fused_photometric: bool = False,
) -> ExactKDraws:
    """Draw :class:`ExactKDraws` for a ``B >= 16`` batch from ``gen``; with
    ``fused_photometric``, the fused route's (no ``positional_flip``, seeds
    instead of a noise field)."""
    if b < 16:
        raise ValueError(f"the exact-k path takes B >= 16, got {b}")
    k = round(P_CROP * b)
    if positional_crop:
        crop_rows = torch.arange(k, device=device)
    else:
        crop_rows = torch.randperm(b, generator=gen, device=device)[:k]
    window = _crop_window(torch.rand((k, 4), generator=gen, device=device), h, w)

    rotate_rows = angles = None
    if rotate:
        rk = round(P_ROTATE * b)
        rotate_rows = torch.randperm(b, generator=gen, device=device)[:rk]
        angles = _rotation_angles(gen, rk, device)

    n_noise, n_glass, n_motion = _photometric_counts(b)
    n3 = n_noise + n_glass + n_motion
    # k + n3 = 4 round(B / 5) <= B for every B >= 10, so the block fits
    photo_start = k if positional_crop else None
    if photo_start is not None:
        # contiguous ranges after the crop rows: under a shuffled feed the
        # batch position is already a uniform permutation
        rows = torch.arange(photo_start, photo_start + n3, device=device)
    else:
        rows = torch.randperm(b, generator=gen, device=device)[:n3]
    sels = (rows[:n_noise], rows[n_noise : n_noise + n_glass], rows[n_noise + n_glass :])

    positional_flip = bool(positional_crop) and b % 2 == 0 and not fused_photometric
    if positional_flip:
        flip = (torch.arange(b, device=device) % 2).float()
    else:
        flip = _bernoulli(gen, P_FLIP, b, device).float()
    do_bc = _bernoulli(gen, P_BC, b, device)
    alpha = torch.where(do_bc, 1.0 + _uniform(gen, (b,), -0.2, 0.2, device), 1.0)
    beta = torch.where(do_bc, _uniform(gen, (b,), -0.2, 0.2, device) * 255.0, 0.0)
    zeros = torch.zeros((b,), device=device)
    sigma = zeros.index_put((sels[0],), torch.sqrt(_uniform(gen, (n_noise,), 10.0, 400.0, device)))
    glass = zeros.index_fill(0, sels[1], 1.0)
    motion = zeros.index_fill(0, sels[2], 1.0)
    mbin = torch.randint(0, 16, (b,), generator=gen, device=device).float()
    scalars = torch.stack([flip, alpha, beta, sigma, glass, motion, mbin, zeros], dim=1)
    if fused_photometric:
        seeds = torch.randint(0, 2**31 - 1, (3 * b,), generator=gen, device=device,
                              dtype=torch.int32)
        return ExactKDraws(crop_rows, window, scalars, sels, None, photo_start,
                           positional_flip, rotate_rows, angles, seeds)
    noise = torch.randn((n_noise, h, w, 3), generator=gen, device=device, dtype=torch.bfloat16)
    return ExactKDraws(crop_rows, window, scalars, sels, noise, photo_start,
                       positional_flip, rotate_rows, angles)


def _apply_photometric_subset(imgs, scalars, sels, noise, photo_start, positional_flip):
    """fdtpu's ``_apply_photometric_xla_subset`` for disjoint subsets: flip
    and brightness/contrast over the whole batch, noise and the two blurs
    on one block of rows (a contiguous slice with ``photo_start``, a gather
    otherwise) with both blurs as one grouped convolution, clip and /255 in
    bfloat16."""
    noise_sel, glass_sel, motion_sel = sels
    n = noise_sel.shape[0]
    imgs = imgs.to(torch.bfloat16)
    bf = imgs.dtype
    if positional_flip:
        lin = imgs.clone()
        lin[1::2] = imgs[1::2].flip(2)
    else:
        lin = torch.where(scalars[:, 0, None, None, None] > 0.5, imgs.flip(2), imgs)
    lin = lin * _col(scalars[:, 1], bf) + _col(scalars[:, 2], bf)

    def finish(x):
        return x.clamp(0.0, 255.0) / 255.0

    if photo_start is not None:
        rows = slice(photo_start, photo_start + n + glass_sel.shape[0] + motion_sel.shape[0])
    else:
        rows = torch.cat([noise_sel, glass_sel, motion_sel])
    sub = lin[rows]
    sigma = _col(scalars[noise_sel, 3], bf)
    noised = sub[:n] + sigma * noise
    g7 = F.pad(_gaussian_kernel5(device=imgs.device), (1, 1, 1, 1))  # 5x5 in 7x7
    ang = (scalars[motion_sel, 6] + 0.5) * math.pi / 16.0
    kerns = torch.cat([g7.expand(glass_sel.shape[0], 7, 7), _motion_kernel7(ang)])
    blurred = _depthwise_filter_batch(sub[n:], kerns)
    out = finish(lin)
    out[rows] = finish(torch.cat([noised, blurred]))
    return out


def apply_exact_k(imgs, boxes, masks, d: ExactKDraws, fused_photometric: bool = False):
    """The exact-k path: crop, rotation, flip and photometric on their row
    subsets, then flipped and rounded boxes. bfloat16 images out; with
    ``fused_photometric`` (draws from ``sample_exact_k(...,
    fused_photometric=True)``) float32 throughout, the flip, then one launch
    of the fused photometric kernel over the whole batch."""
    if fused_photometric != (d.seeds is not None):
        raise ValueError("fused_photometric needs the fused route's draws (seeds, no noise) "
                         "and the default route the default draws")
    imgs = imgs.to(torch.float32 if fused_photometric else torch.bfloat16, copy=True)
    w = imgs.shape[2]
    boxes, masks = boxes.clone(), masks.clone()
    ci, cb, cm = _apply_crop(imgs[d.crop_rows], boxes[d.crop_rows], masks[d.crop_rows],
                             *d.crop_window)
    imgs[d.crop_rows], boxes[d.crop_rows], masks[d.crop_rows] = ci, cb, cm
    if d.rotate_rows is not None:
        r = d.rotate_rows
        rb, rm = rotate_boxes(boxes[r], masks[r], d.angles, w)
        imgs[r] = rotate_batch(imgs[r], d.angles)
        boxes[r], masks[r] = rb, rm
    if fused_photometric:
        imgs = torch.where(d.scalars[:, 0, None, None, None] > 0.5, imgs.flip(2), imgs)
        imgs = photometric_batch(imgs, d.scalars, d.seeds)
    else:
        imgs = _apply_photometric_subset(imgs, d.scalars, d.sels, d.noise, d.photo_start,
                                         d.positional_flip)
    boxes = _round_coords(_flip_boxes(boxes, d.scalars[:, 0], w))
    return imgs, boxes, masks


# -- entry points ------------------------------------------------------------------------


def augment_batch_fast(gen: torch.Generator, imgs, boxes, masks, rotate: bool = False,
                       positional_crop: bool = False, fused_photometric: bool = False):
    """Augment a ``(B, H, W, 3)`` uint8 batch with padded ``(B, N, 5)``
    boxes and ``(B, N)`` masks, drawing from ``gen`` (on the batch's
    device). ``B < 16``: per-sample gates, float32 images; ``B >= 16``:
    exact-k subsets, bfloat16 images, or float32 through the fused
    photometric kernel with ``fused_photometric`` (which changes nothing
    below 16). ``rotate`` adds the Rotate op on the card;
    ``positional_crop`` (shuffled feeds only) takes the subsets as row
    ranges. Returns ``(images in [0, 1], boxes, masks)``."""
    b, h, w = imgs.shape[:3]
    if b < 16:
        draws = sample_per_sample(gen, b, h, w, imgs.device, rotate)
        return apply_per_sample(imgs, boxes, masks, draws)
    draws = sample_exact_k(gen, b, h, w, imgs.device, rotate, positional_crop, fused_photometric)
    return apply_exact_k(imgs, boxes, masks, draws, fused_photometric)


def resize_only_batch(imgs, boxes, masks):
    """Val/test path: scale to [0, 1] in float32 (the resize happened at
    decode) and apply the min-area filter."""
    valid = masks & (boxes[..., 3] * boxes[..., 4] >= MIN_AREA)
    return imgs.float() / 255.0, boxes, valid
