"""The train step's augmentation of a batch of fewer than 16 images, in
plain float32 PyTorch: the draws, in the program's order from the step's
generator, and their application.

Per image (the reference repository's Albumentations pipeline,
``datamodule.py:105-125``, as the program gates it per sample):
RandomResizedCrop (p 0.2, scale 0.08-1, ratio 3/4-4/3, linear resampling),
horizontal flip (0.5), brightness and contrast (0.2, +-0.2), Gaussian
noise (0.2, variance 10-400), glass blur (0.2, 5x5 Gaussian of sigma 0.7),
motion blur (0.2, a 7x7 line), a clip to [0, 255], boxes rounded half to
even; then rotation (0.2, +-20 degrees) by three shears about the centre
with reflect-101 borders, each shear a linear interpolation along one axis.
The program computes the photometric chain in bfloat16; here every step is
float32. The boxes, float32 on both sides, come out the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.nn import FLOAT32, Precision

MIN_AREA = 10.0
ROTATE_LIMIT = math.radians(20.0)


def draw(gen: torch.Generator, b: int, h: int, w: int, device, rotate: bool) -> dict:
    """Every random choice of a step, drawn as the program draws them."""
    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    def uniform(n, lo, hi):
        return lo + rand((n,)) * (hi - lo)

    d = {}
    do_crop = rand((b,)) < 0.2
    d["window"] = crop_window(rand((b, 4)), h, w, do_crop)
    do_bc = rand((b,)) < 0.2
    d["alpha"] = torch.where(do_bc, 1.0 + uniform(b, -0.2, 0.2), 1.0)
    d["beta"] = torch.where(do_bc, uniform(b, -0.2, 0.2) * 255.0, 0.0)
    d["flip"] = rand((b,)) < 0.5
    d["noise_gate"] = rand((b,)) < 0.2
    d["sigma"] = torch.sqrt(uniform(b, 10.0, 400.0))
    d["glass"] = rand((b,)) < 0.2
    d["motion"] = rand((b,)) < 0.2
    d["motion_angle"] = uniform(b, 0.0, math.pi)
    d["noise"] = torch.randn((b, h, w, 3), generator=gen, device=device,
                             dtype=torch.bfloat16).float()
    if rotate:
        gate = rand((b,)) < 0.2
        d["rotate_gate"] = gate
        d["angles"] = torch.where(gate, uniform(b, -ROTATE_LIMIT, ROTATE_LIMIT), 0.0)
    return d


def crop_window(u, h: int, w: int, do_crop):
    area = (0.08 + u[:, 0] * (1.0 - 0.08)) * (w * h)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    ratio = torch.exp(lo + u[:, 1] * (hi - lo))
    cw = torch.sqrt(area * ratio).clamp(8.0, w)
    ch = torch.sqrt(area / ratio).clamp(8.0, h)
    cx, cy = u[:, 2] * (w - cw), u[:, 3] * (h - ch)
    return (torch.where(do_crop, cx, 0.0), torch.where(do_crop, cy, 0.0),
            torch.where(do_crop, cw, float(w)), torch.where(do_crop, ch, float(h)))


def _resample_weights(size: int, offset, span):
    """``(K, in, out)`` weights of a linear resize of ``[offset, offset +
    span)`` to ``size`` samples (a crop only enlarges, so clamping the
    sample position stands in for renormalising at the border)."""
    ar = torch.arange(size, dtype=torch.float32, device=offset.device)
    pos = (offset[:, None] + (ar + 0.5) * (span / size)[:, None] - 0.5).clamp(0.0, size - 1.0)
    return (1.0 - (pos[:, None, :] - ar[None, :, None]).abs()).clamp_min(0.0)


def crop(imgs, boxes, masks, window):
    cx, cy, cw, ch = window
    h, w = imgs.shape[1], imgs.shape[2]
    sy, sx = (h / ch)[:, None], (w / cw)[:, None]
    out = torch.einsum("khwc,kho->kowc", imgs, _resample_weights(h, cy, ch))
    out = torch.einsum("kowc,kwp->kopc", out, _resample_weights(w, cx, cw))
    bx = (boxes[..., 1] - cx[:, None]) * sx
    by = (boxes[..., 2] - cy[:, None]) * sy
    bw, bh = boxes[..., 3] * sx, boxes[..., 4] * sy
    x0, y0 = bx.clamp(0, w), by.clamp(0, h)
    x1, y1 = (bx + bw).clamp(0, w), (by + bh).clamp(0, h)
    bw, bh = x1 - x0, y1 - y0
    boxes = torch.stack([boxes[..., 0], x0, y0, bw, bh], dim=-1)
    return out, boxes, masks & (bw * bh >= MIN_AREA) & (bw > 0) & (bh > 0)


def _filter(imgs, kernels):
    """Each ``(H, W, C)`` image filtered on every channel by its own
    ``(k, k)`` kernel, zero-padded to the same size."""
    kb, h, w, c = imgs.shape
    lhs = imgs.permute(0, 3, 1, 2).reshape(1, kb * c, h, w)
    rhs = kernels.repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(lhs, rhs, padding=kernels.shape[-1] // 2, groups=kb * c)
    return out.reshape(kb, c, h, w).permute(0, 2, 3, 1)


def gaussian5(device, sigma: float = 0.7):
    r = torch.arange(-2, 3, dtype=torch.float32, device=device)
    k = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return torch.outer(k, k)


def motion7(angle):
    r = torch.arange(-3, 4, dtype=torch.float32, device=angle.device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    dx, dy = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    k = (1.0 - (-dy * xx + dx * yy).abs()).clamp_min(0.0) * ((dx * xx + dy * yy).abs() <= 3.0)
    return k / k.sum(dim=(1, 2), keepdim=True).clamp_min(1e-6)


def _round_boxes(boxes):
    return torch.cat([boxes[..., :1], torch.round(boxes[..., 1:])], dim=-1)


def apply(imgs_u8, boxes, masks, d: dict, prec: Precision = FLOAT32):
    """-> ``(images (B, H, W, 3) float32 in [0, 1], boxes, masks)``.
    ``prec`` rounds the photometric chain where the program rounds it to
    its compute dtype (the control's lower precision; float32 rounds
    nothing)."""
    b, h, w, _ = imgs_u8.shape
    r = prec.round

    def col(v):
        return r(v.float()[:, None, None, None])

    img, boxes, masks = crop(imgs_u8.float(), boxes, masks, d["window"])
    img = r(img)
    img = torch.where(d["flip"][:, None, None, None], img.flip(2), img)
    x0 = torch.where(d["flip"][:, None], w - boxes[..., 1] - boxes[..., 3], boxes[..., 1])
    boxes = torch.cat([boxes[..., :1], x0[..., None], boxes[..., 2:]], dim=-1)
    img = r(r(img * col(d["alpha"])) + col(d["beta"]))
    img = r(img + col(d["noise_gate"]) * r(r(d["noise"]) * col(d["sigma"])))
    g = gaussian5(img.device)
    img = torch.where(col(d["glass"]) > 0.5, r(_filter(img, r(g).expand(b, 5, 5))), img)
    img = torch.where(col(d["motion"]) > 0.5, r(_filter(img, r(motion7(d["motion_angle"])))),
                      img)
    img = img.clamp(0.0, 255.0) / 255.0
    boxes = _round_boxes(boxes)
    if "angles" not in d:
        return img, boxes, masks
    gate = d["rotate_gate"]
    rot = rotate(img * 255.0, d["angles"]) / 255.0
    rb, rm = rotate_boxes(boxes, masks, d["angles"], w)
    img = torch.where(gate[:, None, None, None], rot, img)
    boxes = torch.where(gate[:, None, None], _round_boxes(rb), boxes)
    masks = torch.where(gate[:, None], rm, masks)
    return img, boxes, masks


# -- rotation by three shears -------------------------------------------------------


def _margin(size: int) -> int:
    """The reflect margin: the farthest a 20-degree shear moves a kept
    pixel, rounded up to 8."""
    return max(8 * math.ceil(0.30 * size / 8), 16)


def _reflect(n: int, pad: int, device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect")).to(device)


def _shift(x: torch.Tensor, t: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """``out[..., l] = (1 - f) x[l + n step] + f x[l + (n + 1) step]``
    along ``dim`` of ``x`` (K, R, L), with ``t`` broadcast to it, ``n =
    floor(t)``, ``f = t - n``; taps outside read 0."""
    n = torch.floor(t)
    f = t - n
    size = x.shape[dim]
    base = torch.arange(size, device=x.device)
    base = base.view((1, size, 1) if dim == 1 else (1, 1, size))
    src = base + n.long() * step
    out = 0.0
    for tap, weight in ((src, 1.0 - f), (src + step, f)):
        tap = tap.expand(x.shape)
        inside = (tap >= 0) & (tap < size)
        out = out + weight * torch.where(inside, x.gather(dim, tap.clamp(0, size - 1)), 0.0)
    return out


def rotate(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """``(K, S, S, 3)`` float32 images rotated counterclockwise by
    ``angles`` about the centre: ``ShearX(-tan(a/2)) ShearY(sin a)
    ShearX(-tan(a/2))`` on the reflect-padded image, then cropped back."""
    k, s, _, c = imgs.shape
    pad = _margin(s)
    idx = _reflect(s, pad, imgs.device)
    x = imgs.index_select(1, idx).index_select(2, idx)
    hp = x.shape[1]
    x = x.reshape(k, hp, hp * c)  # lanes interleave x and channel
    center = pad + (s - 1) / 2.0
    k1 = -torch.tan(angles / 2.0)
    k2 = torch.sin(angles)
    rows = torch.arange(hp, dtype=torch.float32, device=imgs.device)
    lane_x = torch.div(torch.arange(hp * c, device=imgs.device), c, rounding_mode="floor").float()
    t_rows = (k1[:, None] * (rows - center))[:, :, None]  # shift of each row, in pixels
    x = _shift(x, t_rows, 2, c)
    x = _shift(x, (k2[:, None] * (lane_x - center))[:, None, :], 1, 1)
    x = _shift(x, t_rows, 2, c)
    return x[:, pad:pad + s, c * pad:c * (pad + s)].reshape(k, s, s, c)


def rotate_boxes(boxes, masks, angles, size: int):
    """Each box's corners rotated, their axis-aligned hull clipped to the
    image, the min-area filter."""
    a = angles[:, None, None]
    cos, sin = torch.cos(a), torch.sin(a)
    c = (size - 1) / 2.0
    x, y, bw, bh = boxes[..., 1], boxes[..., 2], boxes[..., 3], boxes[..., 4]
    px = torch.stack([x, x + bw, x, x + bw], -1) - c
    py = torch.stack([y, y, y + bh, y + bh], -1) - c
    rx = cos * px + sin * py + c
    ry = -sin * px + cos * py + c
    x0, x1 = rx.amin(-1).clamp(0, size), rx.amax(-1).clamp(0, size)
    y0, y1 = ry.amin(-1).clamp(0, size), ry.amax(-1).clamp(0, size)
    nw, nh = x1 - x0, y1 - y0
    out = torch.stack([boxes[..., 0], x0, y0, nw, nh], dim=-1)
    return out, masks & (nw * nh >= MIN_AREA) & (nw > 0) & (nh > 0)
