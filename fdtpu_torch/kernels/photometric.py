"""The fused photometric chain: the counterpart of
``fdtpu/kernels/augment_pallas.py`` (K5).

On every ``(image, channel)`` plane of an already cropped and flipped
batch on the 0-255 scale, in this order:

1. brightness/contrast ``x * alpha + beta``;
2. Gaussian noise ``x + sigma * n``: ``n`` is a Box-Muller normal of two
   murmur3-mixed counters (``idx = r * W + c`` XOR the plane's mixed seed),
   so the field is set by the seeds alone and matches fdtpu's bit for bit;
   ``sigma`` 0 keeps ``x`` (a multiply, not a branch);
3. the 5x5 Gaussian blur (sigma 0.7) as a vertical, then a horizontal
   5-tap pass with zero padding, where ``glass > 0.5``;
4. the 7x7 motion blur along one of 16 quantized directions
   (:data:`MOTION_TAPS`), zero padding, where ``motion > 0.5``;
5. ``clip(x, 0, 255) / 255``, a true division.

``scalars`` is fdtpu's ``(B, 8)`` table (:data:`FLIP` .. :data:`MDY`); the
direction bin rides in column :data:`MDX`. :func:`photometric_batch`
dispatches on where the images lie: a CPU tensor runs
:func:`photometric_reference`, a CUDA tensor launches the hand-written
kernel (``csrc/photometric.cu``) or the call raises;
``LAUNCHES["photometric"]`` counts kernel launches (``kernels/launches.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.kernels.launches import LAUNCHES

# scalar table columns (augment_pallas.py:58)
FLIP, ALPHA, BETA, NOISE_SIGMA, GLASS, MOTION, MDX, MDY = range(8)
NSCALARS = 8
N_DIRS = 16
_MASK32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))  # jnp's weak-typed 2 pi, in float32


def _gauss5_taps(sigma: float = 0.7) -> list[float]:
    """The separable 5-tap Gaussian, computed in float32 as fdtpu does."""
    r = np.arange(-2, 3, dtype=np.float32)
    k = np.exp(-(r**2) / (2 * sigma**2))
    return (k / k.sum()).tolist()


def _motion_taps(n_dirs: int = N_DIRS) -> list[list[tuple[int, int, float]]]:
    """``(dy, dx, weight)`` tap lists, dy outer and dx inner, of the 7x7
    triangle line kernel at ``n_dirs`` fixed angles in [0, pi); each weight
    is computed in float64 and cast to float32 once, as ``jnp.float32(wk)``
    does in the TPU kernel."""
    out = []
    for k in range(n_dirs):
        ang = (k + 0.5) * np.pi / n_dirs
        dxv, dyv = np.cos(ang), np.sin(ang)
        taps = []
        for dy in range(-3, 4):
            for dx in range(-3, 4):
                dist = abs(-dyv * dx + dxv * dy)
                along = abs(dxv * dx + dyv * dy)
                wk = max(0.0, 1.0 - dist) * (1.0 if along <= 3.0 else 0.0)
                if wk > 1e-6:
                    taps.append((dy, dx, wk))
        total = sum(t[2] for t in taps)
        out.append([(dy, dx, float(np.float32(wk / total))) for dy, dx, wk in taps])
    return out


G5 = _gauss5_taps()
MOTION_TAPS = _motion_taps()


def _kernel_tables(max_taps: int = 16):
    """The tap tables as the kernel's launch takes them (copied into its
    parameters): Gaussian ``(5,)`` float32, tap counts ``(16,)`` int32,
    weights ``(16, max_taps)`` float32 and ``[dy, dx]`` offsets ``(16,
    max_taps, 2)`` int32."""
    counts = np.asarray([len(t) for t in MOTION_TAPS], dtype=np.int32)
    if counts.max() > max_taps:
        raise ValueError(f"a direction has {counts.max()} taps, the kernel takes {max_taps}")
    weights = np.zeros((N_DIRS, max_taps), dtype=np.float32)
    offsets = np.zeros((N_DIRS, max_taps, 2), dtype=np.int32)
    for k, taps in enumerate(MOTION_TAPS):
        for j, (dy, dx, wk) in enumerate(taps):
            weights[k, j], offsets[k, j] = wk, (dy, dx)
    return np.asarray(G5, dtype=np.float32), counts, weights, offsets


_KERNEL_TABLES = _kernel_tables()  # kept alive here for ctypes


# -- the plain version ----------------------------------------------------------------


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """``z * c mod 2^32`` for ``z`` in [0, 2^32) held in int64: two products
    of 16-bit halves of ``c``, each below 2^48, so nothing overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (z * lo + (((z * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(z: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def noise_field(seeds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(P, H, W)`` float32 standard normals of the planes with ``seeds``
    ``(P,)``: Box-Muller over ``mix(idx ^ seed)`` and ``mix((idx ^ seed) +
    0x68E31DA4)``, ``seed = mix(uint32(seeds[i]) * 0x9E3779B9)``."""
    dev = seeds.device
    idx = (torch.arange(h, device=dev)[:, None] * w + torch.arange(w, device=dev)).to(torch.int64)
    seed = _mix(_mul32(seeds.to(torch.int64) & _MASK32, 0x9E3779B9))
    z = idx[None] ^ seed[:, None, None]
    bits1 = _mix(z)
    bits2 = _mix((z + 0x68E31DA4) & _MASK32)
    scale = torch.tensor(float(1 << 24), device=dev)
    u1 = torch.maximum((bits1 >> 8).float() / scale, torch.tensor(1e-7, device=dev))
    u2 = (bits2 >> 8).float() / scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


def _gauss_pass(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One 5-tap pass along ``dim`` with zero padding, summed left to right
    as ``G0 x[i+2] + G1 x[i+1] + G2 x[i] + G3 x[i-1] + G4 x[i-2]``."""
    n = x.shape[dim]
    pad = [0, 0, 0, 0]
    pad[2 * (x.dim() - 1 - dim)] = pad[2 * (x.dim() - 1 - dim) + 1] = 2
    xp = torch.nn.functional.pad(x, pad)
    acc = None
    for j, g in enumerate(G5):  # tap j reads x[i + 2 - j]
        term = g * xp.narrow(dim, 4 - j, n)
        acc = term if acc is None else acc + term
    return acc


def _motion(x: torch.Tensor, taps) -> torch.Tensor:
    """``sum w * x[r + dy, c + dx]`` over ``taps`` in order, from 0, with
    zero padding; ``x`` ``(P, H, W)``."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (3, 3, 3, 3))
    acc = torch.zeros_like(x)
    for dy, dx, wk in taps:
        acc = acc + wk * xp[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
    return acc


def photometric_reference(imgs: torch.Tensor, scalars: torch.Tensor, seeds: torch.Tensor):
    """Plain PyTorch :func:`photometric_batch`: ``(B, H, W, 3)`` float32 on
    the 0-255 scale, already flipped; ``scalars`` ``(B, 8)`` float32;
    ``seeds`` ``(B * 3,)`` int32. Returns ``(B, H, W, 3)`` float32 in
    [0, 1]. The kernel matches it bit for bit where no plane is noised, and
    within 1e-6 where one is (its ``logf``/``cosf`` against PyTorch's
    ``log``/``cos``; on the H100 they too agree bit for bit)."""
    b, h, w, c = imgs.shape
    x = imgs.permute(0, 3, 1, 2)  # (B, 3, H, W) planes, plane i = 3 b + ch
    col = lambda j: scalars[:, j, None, None, None]  # noqa: E731
    x = x * col(ALPHA) + col(BETA)
    x = x + col(NOISE_SIGMA) * noise_field(seeds, h, w).reshape(b, c, h, w)
    glass = _gauss_pass(_gauss_pass(x, 2), 3)
    x = torch.where(col(GLASS) > 0.5, glass, x)
    bins = scalars[:, MDX].long().clamp(0, N_DIRS - 1)  # lax.switch clamps its index
    moving = scalars[:, MOTION] > 0.5
    out = x.clone()
    for k in range(N_DIRS):
        rows = torch.nonzero(moving & (bins == k)).flatten()
        if rows.numel():
            out[rows] = _motion(x[rows], MOTION_TAPS[k])
    out = out.clamp(0.0, 255.0) / torch.tensor(255.0, device=imgs.device)
    return out.permute(0, 2, 3, 1).contiguous()


# -- the dispatching wrapper ------------------------------------------------------------


def _check(imgs: torch.Tensor, scalars: torch.Tensor, seeds: torch.Tensor) -> None:
    if imgs.dim() != 4 or imgs.shape[3] != 3 or min(imgs.shape) < 1:
        raise ValueError(f"imgs must be a non-empty (B, H, W, 3), got {tuple(imgs.shape)}")
    b = imgs.shape[0]
    if imgs.dtype != torch.float32:
        raise TypeError(f"imgs must be float32, got {imgs.dtype}")
    if scalars.dtype != torch.float32 or scalars.shape != (b, NSCALARS):
        raise ValueError(f"scalars must be float32 ({b}, {NSCALARS}), got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    if seeds.dtype != torch.int32 or seeds.shape != (3 * b,):
        raise ValueError(f"seeds must be int32 ({3 * b},), got {seeds.dtype} {tuple(seeds.shape)}")
    if scalars.device != imgs.device or seeds.device != imgs.device:
        raise ValueError("imgs, scalars and seeds must lie on one device")
    if imgs.numel() >= 2**31:
        raise ValueError("imgs too large for 32-bit pixel indices")


def photometric_batch(imgs: torch.Tensor, scalars: torch.Tensor, seeds: torch.Tensor):
    """The fused photometric chain on ``(B, H, W, 3)`` float32 images (0-255
    scale, flipped): ``(B, H, W, 3)`` float32 in [0, 1]. One launch on the
    card."""
    _check(imgs, scalars, seeds)
    if imgs.device.type == "cpu":
        return photometric_reference(imgs, scalars, seeds)
    if imgs.device.type != "cuda":
        raise ValueError(f"no kernel for device {imgs.device}")
    from fdtpu_torch.kernels import build

    imgs, scalars, seeds = imgs.contiguous(), scalars.contiguous(), seeds.contiguous()
    if imgs.data_ptr() % 16:  # the kernel moves 16-byte vectors: a view at an odd offset
        imgs = imgs.clone()
    lib = build.load_library()
    out = torch.empty_like(imgs)
    b, h, w, _ = imgs.shape
    dev = imgs.device.index if imgs.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.fdtpu_photometric(
            imgs.data_ptr(), out.data_ptr(), scalars.data_ptr(), seeds.data_ptr(), b, h, w,
            *(t.ctypes.data for t in _KERNEL_TABLES), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"photometric kernel launch failed: {build.cuda_error_string(err)}")
    LAUNCHES["photometric"] += 1
    return out

