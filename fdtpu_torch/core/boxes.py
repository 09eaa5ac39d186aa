"""Box-format conversions and pairwise IoU (``fdtpu/core/boxes.py``).

Rows follow fdtpu's ``[conf, x, y, w, h]`` layout where ``(x, y)`` is the
top-left corner in pixels; variable-length lists are fixed-capacity arrays
plus a bool mask.
"""

from __future__ import annotations

import numpy as np
import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., (x, y, w, h)]`` -> ``[..., (x0, y0, x1, y1)]``."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., (x0, y0, x1, y1)]`` -> ``[..., (x, y, w, h)]``."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def cxywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., (conf, x, y, w, h)]`` -> ``[..., (conf, x0, y0, x1, y1)]``."""
    return torch.cat([boxes[..., :1], xywh_to_xyxy(boxes[..., 1:5])], dim=-1)


def cxyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cxywh_to_xyxy`."""
    return torch.cat([boxes[..., :1], xyxy_to_xywh(boxes[..., 1:5])], dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Area of ``[..., (x0, y0, x1, y1)]`` boxes (clamped at 0)."""
    w = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]).clamp_min(0.0)
    h = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]).clamp_min(0.0)
    return w * h


def box_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between ``(..., N, 4)`` and ``(..., M, 4)`` xyxy boxes ->
    ``(..., N, M)``; 0 where the union is empty."""
    lt = torch.maximum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.minimum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a_xyxy)[..., :, None] + box_area(b_xyxy)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)


def masked_box_iou(a_xyxy: torch.Tensor, a_mask: torch.Tensor, b_xyxy: torch.Tensor,
                   b_mask: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with padded rows zeroed out: ``(..., N, 4)`` boxes with
    an ``(..., N)`` bool mask against ``(..., M, 4)`` and ``(..., M)``;
    a pair with an invalid row has IoU 0."""
    pair_mask = a_mask[..., :, None] & b_mask[..., None, :]
    return torch.where(pair_mask, box_iou(a_xyxy, b_xyxy), 0.0)


def pad_boxes(boxes, capacity: int):
    """Host-side helper: pad an ``(n, 5)`` cxywh array to ``(capacity, 5)``.

    Returns numpy ``(padded, mask)``; truncates if ``n > capacity``.
    """
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 5)
    n = min(boxes.shape[0], capacity)
    out = np.zeros((capacity, 5), dtype=np.float32)
    out[:n] = boxes[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask
