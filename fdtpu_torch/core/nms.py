"""YOLO-grid decode + filter + NMS (``fdtpu/core/nms.py`` names), as thin
wrappers over ``fdtpu_torch.kernels.nms``.

The port has one NMS semantics at every batch size, that of fdtpu's Pallas
kernel: every above-threshold candidate enters the greedy loop and kept rows
come out compacted. fdtpu's XLA twin, which first truncates to the
top-``capacity`` scores, has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.kernels.nms import decode_filter_nms_batch, grid_tables_on

DEFAULT_CAPACITY = 128


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
    unbatched = fm.dim() == 3
    if unbatched:
        fm = fm[None]
    tables = grid_tables_on(num_patches, tuple(image_size), fm.device)
    boxes, mask = decode_filter_nms_batch(
        fm.reshape(fm.shape[0], -1, 5), tables,
        probability_threshold, iou_threshold, capacity,
    )
    if unbatched:
        return boxes[0], mask[0]
    return boxes, mask


def compact_boxes(boxes, mask) -> np.ndarray:
    """Host-side helper: drop masked rows -> ragged ``(n, 5)`` numpy array."""
    if isinstance(boxes, torch.Tensor):
        boxes = boxes.detach().cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return np.asarray(boxes)[np.asarray(mask)]
