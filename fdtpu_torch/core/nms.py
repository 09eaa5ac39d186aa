"""Decode + filter + NMS of the YOLO grid and of the SSD's priors
(``fdtpu/core/nms.py`` names), as thin wrappers over
``fdtpu_torch.kernels.nms`` (K1), batched ``(B, ...)`` or unbatched.

The port has one NMS semantics at every batch size, that of fdtpu's Pallas
kernel: every above-threshold candidate enters the greedy loop and kept rows
come out compacted. fdtpu's XLA twin, which first truncates to the
top-``capacity`` scores, has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.kernels.nms import (
    decode_filter_nms_batch,
    grid_tables_on,
    ssd_output_tables_on,
    ssd_tables_on,
)

DEFAULT_CAPACITY = 128


def _filter_nms(rows, tables_fn, probability_threshold, iou_threshold, capacity,
                indexed=False):
    """K1 over ``(B, N, 5)`` rows, or over unbatched ``(N, 5)`` ones;
    ``tables_fn(device)`` gives the decode tables; ``indexed`` adds the
    kept rows' candidate indices to the outputs."""
    unbatched = rows.dim() == 2
    if unbatched:
        rows = rows[None]
    out = decode_filter_nms_batch(
        rows, tables_fn(rows.device), probability_threshold, iou_threshold, capacity, indexed)
    if unbatched:
        return tuple(t[0] for t in out)
    return out


def decode_filter_nms(
    fm: torch.Tensor,
    num_patches: int,
    image_size: tuple[int, int],
    probability_threshold: float,
    iou_threshold: float,
    capacity: int = DEFAULT_CAPACITY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode + filter + NMS of a ``(B, S, S, 5)`` (or unbatched
    ``(S, S, 5)``) grid map. Returns ``(boxes, mask)``: ``(..., capacity, 5)``
    rows ``[score, x, y, w, h]`` in pixels and a ``(..., capacity)`` bool mask.
    """
    rows = fm.reshape(*fm.shape[:-3], -1, 5)
    return _filter_nms(rows, lambda d: grid_tables_on(num_patches, tuple(image_size), d),
                       probability_threshold, iou_threshold, capacity)


def ssd_decode_filter_nms(
    x: torch.Tensor,
    patch_sizes: tuple[int, ...],
    image_size: tuple[int, int],
    probability_threshold: float,
    iou_threshold: float,
    capacity: int = DEFAULT_CAPACITY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode + filter + NMS of ``(B, N, 5)`` (or ``(N, 5)``) raw encoded
    prior rows, priors not applied: the decode tables fold them in."""
    return _filter_nms(x, lambda d: ssd_tables_on(tuple(patch_sizes), tuple(image_size), d),
                       probability_threshold, iou_threshold, capacity)


def ssd_output_filter_nms(
    x: torch.Tensor,
    image_size: tuple[int, int],
    probability_threshold: float,
    iou_threshold: float,
    capacity: int = DEFAULT_CAPACITY,
    indexed: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Filter + NMS of a model's normalized prior rows, ``(B, N, 5)`` (or
    ``(N, 5)``) ``[score, x, y, w, h]`` with the priors applied in the graph
    (the SSD's, RetinaFace's): only the pixel scaling remains. ``indexed``
    adds each kept row's candidate index, ``(..., capacity)`` int32, -1
    past the kept rows."""
    return _filter_nms(x, lambda d: ssd_output_tables_on(x.shape[-2], tuple(image_size), d),
                       probability_threshold, iou_threshold, capacity, indexed)


def compact_boxes(boxes, mask) -> np.ndarray:
    """Host-side helper: drop masked rows -> ragged ``(n, 5)`` numpy array."""
    if isinstance(boxes, torch.Tensor):
        boxes = boxes.detach().cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return np.asarray(boxes)[np.asarray(mask)]
