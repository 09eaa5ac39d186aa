"""SSD multi-scale prior grid: priors, target encoding, decoding
(``fdtpu/core/priors.py``); and RetinaFace's anchored priors with their
centre-size decode (:func:`anchor_priors`, :func:`decode_boxes`,
:func:`decode_landmarks`).

Each prior is an anchor at a grid cell's top-left corner with zero extent.
Encoded rows are ``(conf, x_cell_rel, y_cell_rel, w_norm, h_norm)``, the
confidence docked by ``0.001 * patch_size`` so that the cells of a smaller
grid (larger cells) score lower. The default scales ``(60, 30, 15, 7)``
give ``60² + 30² + 15² + 7² = 4774`` priors.

fdtpu's flat prior order is kept: within each scale, row-major over
``(y_cell, x_cell)``, as an NHWC head output flattens. So is its operation
order (``x_enc * scale`` then ``+ prior``; ``conf - 0.001 * ps``;
``(x_n - i / ps) * ps``), one rounding each, so the results are bit-equal
to fdtpu's on the CPU.
"""

from __future__ import annotations

import torch

from fdtpu_torch.core.grid import _scatter_last_wins
from fdtpu_torch.utils.device_cache import device_cache

DEFAULT_PATCH_SIZES: tuple[int, ...] = (60, 30, 15, 7)


def num_priors(patch_sizes: tuple[int, ...] = DEFAULT_PATCH_SIZES) -> int:
    return sum(ps * ps for ps in patch_sizes)


def calculate_priors(
    patch_sizes: tuple[int, ...] = DEFAULT_PATCH_SIZES,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``(N, 4)`` prior offsets ``[x_cell / ps, y_cell / ps, 0, 0]`` in [0, 1]."""
    parts = []
    for ps in patch_sizes:
        cells = torch.arange(ps, dtype=dtype, device=device) / ps
        x_off = cells.expand(ps, ps)  # (row, col)
        y_off = cells[:, None].expand(ps, ps)
        zeros = torch.zeros((ps, ps), dtype=dtype, device=device)
        parts.append(torch.stack([x_off, y_off, zeros, zeros], dim=-1).reshape(ps * ps, 4))
    return torch.cat(parts)


def prior_scales(
    patch_sizes: tuple[int, ...] = DEFAULT_PATCH_SIZES,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``(N,)`` per-prior cell size ``1 / ps``."""
    return torch.cat([torch.full((ps * ps,), 1.0 / ps, dtype=dtype, device=device)
                      for ps in patch_sizes])


@device_cache
def priors_on(patch_sizes: tuple[int, ...], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`calculate_priors` and :func:`prior_scales` in float32 on
    ``device``, made once per ``(patch_sizes, device)``. The tensors are
    shared by every caller and never written. They are made outside
    inference mode even when the first caller runs in it (a ``predict``),
    so that a later forward under autograd may save them."""
    with torch.inference_mode(False):
        return (calculate_priors(patch_sizes, device=device),
                prior_scales(patch_sizes, device=device))


def encode_ssd_targets(
    boxes: torch.Tensor,
    mask: torch.Tensor,
    patch_sizes: tuple[int, ...],
    image_size: tuple[int, int],
) -> torch.Tensor:
    """Encode padded pixel boxes ``(B, K, 5)`` rows ``[conf, x, y, w, h]``
    with validity ``(B, K)`` into ``(B, N, 5)`` multi-scale prior targets.

    The reference's semantics, as fdtpu keeps them: boxes are normalized by
    the image's width and height; at every scale a box goes to the cell
    holding its top-left corner (the offset uses the unclamped cell, the
    write the clamped one); xy are cell-relative (times ``ps``), wh stay
    image-normalized; the confidence is docked ``0.001 * ps``; when boxes
    share a cell the last one wins.
    """
    width, height = image_size
    conf = boxes[..., 0]
    x_n = boxes[..., 1] / width
    y_n = boxes[..., 2] / height
    w_n = boxes[..., 3] / width
    h_n = boxes[..., 4] / height

    parts = []
    for ps in patch_sizes:
        i = torch.floor(x_n * ps)  # x-cell, unclamped
        j = torch.floor(y_n * ps)
        conf_enc = conf - 0.001 * ps
        x_enc = (x_n - i / ps) * ps
        y_enc = (y_n - j / ps) * ps
        ic = i.clamp(0, ps - 1).long()
        jc = j.clamp(0, ps - 1).long()
        vals = torch.stack([conf_enc, x_enc, y_enc, w_n, h_n], dim=-1)
        parts.append(_scatter_last_wins(vals, jc * ps + ic, mask, ps * ps))
    return torch.cat(parts, dim=1)


def apply_priors(x: torch.Tensor, priors: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Map encoded rows ``(..., N, 5)`` to normalized [0, 1] boxes::

        x = x_enc * (1 / ps) + prior_x;  y = y_enc * (1 / ps) + prior_y
        w, h unchanged (the priors have zero extent)
    """
    conf = x[..., 0:1]
    xy = x[..., 1:3] * scales[:, None] + priors[:, 0:2]
    wh = x[..., 3:5] + priors[:, 2:4]
    return torch.cat([conf, xy, wh], dim=-1)


def decode_ssd(
    x: torch.Tensor,
    patch_sizes: tuple[int, ...],
    image_size: tuple[int, int],
    priors: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode ``(..., N, 5)`` encoded rows to pixel-space ``[conf, x, y, w,
    h]`` candidates: :func:`apply_priors`, then x and w times the width, y
    and h times the height."""
    if priors is None:
        priors = calculate_priors(patch_sizes, dtype=x.dtype, device=x.device)
    if scales is None:
        scales = prior_scales(patch_sizes, dtype=x.dtype, device=x.device)
    width, height = image_size
    out = apply_priors(x, priors, scales)
    sx = torch.tensor([1.0, width, height, width, height], dtype=x.dtype, device=x.device)
    return out * sx


# -- anchored priors (RetinaFace) ------------------------------------------------


def feature_maps(image_size: tuple[int, int], steps: tuple[int, ...]) -> list[tuple[int, int]]:
    """``(rows, cols)`` of each level's map for an ``(H, W)`` image:
    ``ceil(H / step)``, ``ceil(W / step)``, as ``prior_box.py`` sizes them."""
    h, w = image_size
    return [(-(-h // s), -(-w // s)) for s in steps]


def anchor_priors(
    min_sizes: tuple[tuple[int, ...], ...],
    steps: tuple[int, ...],
    image_size: tuple[int, int],
    clip: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``(N, 4)`` float32 priors ``[cx, cy, s_kx, s_ky]`` normalised to the
    ``(H, W)`` image, in ``layers/functions/prior_box.py``'s order: level,
    row, column, then the level's ``min_sizes``. Each value is worked out in
    double precision and rounded to float32 once, as the published code
    builds a Python list and makes a float32 tensor of it. ``clip`` clamps
    every value to [0, 1]."""
    h, w = image_size
    levels = []
    for (rows, cols), step, sizes in zip(feature_maps(image_size, steps), steps, min_sizes):
        cy = (torch.arange(rows, dtype=torch.float64) + 0.5) * step / h
        cx = (torch.arange(cols, dtype=torch.float64) + 0.5) * step / w
        k = len(sizes)
        size = torch.tensor(sizes, dtype=torch.float64)
        levels.append(torch.stack([
            cx[None, :, None].expand(rows, cols, k), cy[:, None, None].expand(rows, cols, k),
            (size / w).expand(rows, cols, k), (size / h).expand(rows, cols, k)], -1)
            .reshape(-1, 4))
    out = torch.cat(levels).to(torch.float32)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out.to(device)


@device_cache
def anchors_on(min_sizes: tuple[tuple[int, ...], ...], steps: tuple[int, ...],
               image_size: tuple[int, int], clip: bool, device: torch.device) -> torch.Tensor:
    """:func:`anchor_priors` on ``device``, made once per argument tuple,
    outside inference mode, shared and never written (as :func:`priors_on`)."""
    with torch.inference_mode(False):
        return anchor_priors(min_sizes, steps, image_size, clip, device)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances: tuple[float, float]) -> torch.Tensor:
    """``(..., N, 4)`` offsets -> normalised ``[x0, y0, w, h]`` boxes:
    ``utils/box_utils.py``'s ``decode`` (centre ``c + l * v0 * s``, size ``s
    exp(l * v1)``, then the corner ``centre - size / 2``), left as corner
    and size rather than two corners."""
    centre = priors[:, :2] + loc[..., :2] * variances[0] * priors[:, 2:]
    size = priors[:, 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([centre - size / 2, size], dim=-1)


def decode_landmarks(pre: torch.Tensor, priors: torch.Tensor,
                     variances: tuple[float, float]) -> torch.Tensor:
    """``(..., N, 10)`` offsets -> five normalised points ``[x1, y1, ...,
    x5, y5]``: ``box_utils.py``'s ``decode_landm``, ``c + l * v0 * s``."""
    n = pre.shape[-2]
    points = pre.reshape(*pre.shape[:-1], 5, 2) * variances[0] * priors[:, None, 2:] \
        + priors[:, None, :2]
    return points.reshape(*pre.shape[:-2], n, 10)
