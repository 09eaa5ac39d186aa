"""Three-shear image rotation: the counterpart of
``fdtpu/kernels/rotate_pallas.py``.

The Paeth decomposition ``R(a) = ShearX(-tan(a/2)) . ShearY(sin a) .
ShearX(-tan(a/2))`` about ``((S-1)/2, (S-1)/2)``, with reflect-101 borders
from a pre-pad of ``_pad_for(S)`` pixels on each side. Each shear moves
pixels along one axis by a fractional offset that is linear in the other
axis, with linear interpolation in float32; planes keep the input's dtype
(float32 or bfloat16) between passes.

Two entry points carry every pass, each a hand-written CUDA kernel
(``csrc/rotate_shear.cu``) with its plain PyTorch version beside it:

* :func:`shear_rows` (K3a ``_shear_x_kernel``, and K4 ``_shear_kernel``):
  ``out[i, r, l] = (1-f) in[i, r, l + n c] + f in[i, r, l + (n+1) c]`` with
  ``t = k_i ((r mod row_mod) - center)``, ``n = floor(t)``, ``f = t - n``;
* :func:`shear_cols` (K3b ``_shear_y_kernel``): the same along rows, with
  ``t = k_i ((l // c) - center)``.

Taps outside the plane read 0 (fdtpu's rolls wrap instead; both land only
in the margin the final crop discards). Each wrapper dispatches on where
the planes lie: a CPU tensor runs the plain version, a CUDA tensor launches
the kernel or the call raises; ``LAUNCHES["shear_rows"]`` and
``LAUNCHES["shear_cols"]`` count kernel launches, and
``LAUNCHES["shear_rows_stacked"]`` those of :func:`shear_rows` with
``c = 1`` (K4's channel-stacked layout) among them (``kernels/launches.py``).
:func:`rotate_batch` (K3's NHWC-interleaved layout) and
:func:`rotate_batch_transposed` (K4's channel-stacked layout) compute
``k1 = -tan(a/2)`` and ``k2 = sin a`` once, in float32, and hand the same
values to whichever version runs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fdtpu_torch.kernels.launches import LAUNCHES

ROTATE_LIMIT_RAD = math.radians(20.0) + 1e-3  # datamodule.py:115 limit=20


def _pad_for(size: int) -> int:
    """Reflect-pad margin: covers the worst 20-degree displacement of any
    pixel the final crop keeps, rounded to 8 (``rotate_pallas._pad_for``)."""
    pad = 8 * math.ceil(0.30 * size / 8)
    return max(pad, 16)


def _f32(v: float) -> float:
    return float(np.float32(v))


# -- the plain versions -------------------------------------------------------------


def _blend(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``(1-f) a + f b`` as two rounded products and a rounded sum, the
    kernel's arithmetic (``torch.lerp`` computes ``a + f (b - a)``)."""
    return (1.0 - f) * a + f * b


def _taps(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` gathered along ``dim`` at ``idx``; 0 where ``idx`` is outside."""
    size = x.shape[dim]
    inside = (idx >= 0) & (idx < size)
    return torch.where(inside, x.gather(dim, idx.clamp(0, size - 1)), 0.0)


def shear_rows_reference(planes, k, c: int, row_mod: int, center: float):
    """Plain PyTorch :func:`shear_rows`, bit-equal to the kernel."""
    kk, r, l = planes.shape
    x = planes.float()
    rows = torch.arange(r, device=planes.device)
    if row_mod:
        rows = rows % row_mod
    t = k[:, None] * (rows.float() - center)  # (K, R)
    n = torch.floor(t)
    f = (t - n)[..., None]
    src = torch.arange(l, device=planes.device) + n.long()[..., None] * c  # (K, R, L)
    out = _blend(_taps(x, src, 2), _taps(x, src + c, 2), f)
    return out.to(planes.dtype)


def shear_cols_reference(planes, k, c: int, center: float):
    """Plain PyTorch :func:`shear_cols`, bit-equal to the kernel."""
    kk, r, l = planes.shape
    x = planes.float()
    cols = torch.div(torch.arange(l, device=planes.device), c, rounding_mode="floor")
    t = k[:, None] * (cols.float() - center)  # (K, L)
    n = torch.floor(t)
    f = (t - n)[:, None, :]
    src = torch.arange(r, device=planes.device)[:, None] + n.long()[:, None, :]  # (K, R, L)
    out = _blend(_taps(x, src, 1), _taps(x, src + 1, 1), f)
    return out.to(planes.dtype)


# -- the dispatching wrappers ---------------------------------------------------------


def _check(planes: torch.Tensor, k: torch.Tensor, c: int) -> None:
    if planes.dim() != 3 or min(planes.shape) < 1:
        raise ValueError(f"planes must be a non-empty (K, R, L), got {tuple(planes.shape)}")
    if planes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"planes must be float32 or bfloat16, got {planes.dtype}")
    if k.dtype != torch.float32 or k.shape != planes.shape[:1] or k.device != planes.device:
        raise ValueError("k must be float32 (K,) on the planes' device")
    if c < 1 or planes.shape[2] % c:
        raise ValueError(f"lanes {planes.shape[2]} are not a multiple of c={c}")
    if planes.numel() >= 2**31:
        raise ValueError("planes too large for 32-bit lane and row indices")


def _launch(entry: str, planes, k, *args):
    """Launch ``entry`` of the kernel library on ``planes``' card."""
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    if not (planes.is_contiguous() and k.is_contiguous()):
        raise ValueError("planes and k must be contiguous")
    from fdtpu_torch.kernels import build

    lib = build.load_library()
    out = torch.empty_like(planes)
    kk, r, l = planes.shape
    dev = planes.device.index if planes.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            planes.data_ptr(), out.data_ptr(), k.data_ptr(),
            int(planes.dtype == torch.bfloat16), kk, r, l, *args,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: {build.cuda_error_string(err)}")
    return out


def shear_rows(planes: torch.Tensor, k: torch.Tensor, c: int, row_mod: int, center: float):
    """Shear each row of ``(K, R, L)`` planes along its lanes by
    ``t = k_i ((r mod row_mod) - center)`` pixels of ``c`` lanes each
    (``row_mod`` 0: no modulus). Same dtype out."""
    _check(planes, k, c)
    center = _f32(center)
    if planes.device.type == "cpu":
        return shear_rows_reference(planes, k, c, row_mod, center)
    out = _launch("fdtpu_shear_rows", planes, k, c, row_mod, center)
    LAUNCHES["shear_rows"] += 1
    if c == 1:
        LAUNCHES["shear_rows_stacked"] += 1
    return out


def shear_cols(planes: torch.Tensor, k: torch.Tensor, c: int, center: float):
    """Shear each lane of ``(K, R, L)`` planes along the rows by
    ``t = k_i ((l // c) - center)`` rows. Same dtype out."""
    _check(planes, k, c)
    center = _f32(center)
    if planes.device.type == "cpu":
        return shear_cols_reference(planes, k, c, center)
    out = _launch("fdtpu_shear_cols", planes, k, c, center)
    LAUNCHES["shear_cols"] += 1
    return out


# -- rotation ---------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source indices of a reflect-101 pad of ``n`` by ``pad``, made once per
    shape and device; shared by every caller and never written."""
    return torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect")).to(device)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-101 pad of dims 1 and 2 of ``(K, H, W, ...)`` (``jnp.pad``
    ``mode="reflect"``), by index, in any dtype."""
    rows = _reflect_index(x.shape[1], pad, x.device)
    cols = _reflect_index(x.shape[2], pad, x.device)
    return x.index_select(1, rows).index_select(2, cols)


def _prepare(imgs: torch.Tensor, angles: torch.Tensor):
    kk, s, s2, c = imgs.shape
    if s != s2 or s % 8:
        raise ValueError(f"images must be square with a side divisible by 8, got {s}x{s2}")
    if angles.shape != (kk,):
        raise ValueError(f"angles must be ({kk},), got {tuple(angles.shape)}")
    x = imgs if imgs.is_floating_point() else imgs.float()
    pad = _pad_for(s)
    a = angles.to(device=imgs.device, dtype=torch.float32)
    k1 = -torch.tan(a / 2.0)
    k2 = torch.sin(a)
    return _reflect_pad(x, pad), pad, pad + (s - 1) / 2.0, k1, k2


def _rotate(imgs, angles, rows_fn, cols_fn):
    kk, s, _, c = imgs.shape
    if c != 3:
        raise ValueError(f"rotate_batch takes 3-channel images, got {c}")
    x, pad, center, k1, k2 = _prepare(imgs, angles)
    hp = x.shape[1]
    x = x.reshape(kk, hp, hp * c)  # lanes interleave x and channel
    p1 = rows_fn(x, k1, c, 0, center)
    p2 = cols_fn(p1, k2, c, center)
    p3 = rows_fn(p2, k1, c, 0, center)
    return p3[:, pad : pad + s, c * pad : c * (pad + s)].reshape(kk, s, s, c)


def rotate_batch(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate ``(K, S, S, 3)`` images by ``angles`` radians (counterclockwise)
    about the image center with reflect-101 borders; ``rotate_pallas.
    rotate_batch``. Float in, same dtype out (integer images go in as
    float32); values are pixel-range. ``|angle|`` must stay within
    :data:`ROTATE_LIMIT_RAD`: the margin is sized for it. Three launches on
    the card: :func:`shear_rows`, :func:`shear_cols`, :func:`shear_rows`."""
    return _rotate(imgs, angles, shear_rows, shear_cols)


def rotate_batch_reference(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """:func:`rotate_batch` through the plain versions, on any device."""
    return _rotate(imgs, angles, shear_rows_reference, shear_cols_reference)


def _rotate_transposed(imgs, angles, rows_fn):
    kk, s, _, c = imgs.shape
    x, pad, center, k1, k2 = _prepare(imgs, angles)
    hp = x.shape[1]
    # channels stacked on rows: (K, C*Hp, Hp), row = ch*Hp + y, lane = x
    x = x.permute(0, 3, 1, 2).reshape(kk, c * hp, hp)
    p1 = rows_fn(x, k1, 1, hp, center)
    # the vertical shear as a row shear of the transpose: row = x, lane = (ch, y)
    t2 = rows_fn(p1.transpose(1, 2).contiguous(), k2, 1, 0, center)
    p3 = rows_fn(t2.transpose(1, 2).contiguous(), k1, 1, hp, center)
    out = p3.reshape(kk, c, hp, hp)[:, :, pad : pad + s, pad : pad + s]
    return out.permute(0, 2, 3, 1).contiguous()


def rotate_batch_transposed(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """K4's layout (``rotate_pallas.rotate_batch_transposed``): the same
    rotation on channel-stacked planes, every pass a :func:`shear_rows`
    with ``c = 1`` (``row_mod = Hp`` for the horizontal passes; the
    vertical pass runs on the transpose). Any channel count."""
    return _rotate_transposed(imgs, angles, shear_rows)


def rotate_batch_transposed_reference(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """:func:`rotate_batch_transposed` through the plain version."""
    return _rotate_transposed(imgs, angles, shear_rows_reference)


def rotate_boxes(boxes: torch.Tensor, masks: torch.Tensor, angles: torch.Tensor, size: int):
    """Padded cxywh ``(K, N, 5)`` boxes under the same rotation: corner
    rotation, axis-aligned hull, clip to the image, min-area-10 mask
    (``rotate_pallas.rotate_boxes``)."""
    h = w = float(size)
    a = angles.to(torch.float32)[:, None, None]
    cos, sin = torch.cos(a), torch.sin(a)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    x, y, bw, bh = boxes[..., 1], boxes[..., 2], boxes[..., 3], boxes[..., 4]
    corners_x = torch.stack([x, x + bw, x, x + bw], -1) - cx
    corners_y = torch.stack([y, y, y + bh, y + bh], -1) - cy
    rx = cos * corners_x + sin * corners_y + cx
    ry = -sin * corners_x + cos * corners_y + cy
    x0 = rx.amin(-1).clamp(0, w)
    x1 = rx.amax(-1).clamp(0, w)
    y0 = ry.amin(-1).clamp(0, h)
    y1 = ry.amax(-1).clamp(0, h)
    nw, nh = x1 - x0, y1 - y0
    out = torch.stack([boxes[..., 0], x0, y0, nw, nh], dim=-1)
    return out, masks & (nw * nh >= 10.0) & (nw > 0) & (nh > 0)
