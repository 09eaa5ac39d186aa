"""Serving one frame, in plain PyTorch: ``/255``, the forward, the decode of
every candidate and greedy NMS, with the semantics of the reference
repository's decode as the program keeps them.

A family decodes its own rows (its reference module's ``candidates``);
the linear decode here is the one the grid and the SSD share: a
candidate's box is ``x = x_out * scale_x + offset_x`` (the grid's cell
offsets, or the SSD's pixel scaling of normalised rows), ``w = w_out *
W``; its corners are rounded half to even, and the box is ``[x0, y0, x1 -
x0, y1 - y0]``. A candidate is eligible where its score is above the
probability threshold (strictly). Greedy NMS keeps, round after round, the
eligible candidate of highest score (the lowest index on a tie) and drops
every candidate whose IoU with it exceeds the IoU threshold, until none is
left or ``capacity`` are kept; the kept rows ``[score, x0, y0, w, h]``
come first, in the order kept, the rest are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.nn import FLOAT32, Precision


def _f32(v: float) -> float:
    return float(np.float32(v))


def linear_candidates(rows: torch.Tensor, tables) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 5)`` model rows ``[score, x, y, w, h]`` and a family's decode
    tables -> scores ``(N,)`` and boxes ``(N, 4)`` ``[x0, y0, w, h]`` with
    rounded corners."""
    sx, ox, sy, oy, w_scale, h_scale = tables
    x = rows[:, 1] * sx + ox
    y = rows[:, 2] * sy + oy
    x0, y0 = torch.round(x), torch.round(y)
    x1, y1 = torch.round(x + rows[:, 3] * w_scale), torch.round(y + rows[:, 4] * h_scale)
    return rows[:, 0], torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of ``a`` ``(M, 4)`` with every box of ``b`` ``(K,
    4)``, ``[x0, y0, w, h]``; a box of negative extent has no area, and a
    pair with no union has IoU 0."""
    ax1, ay1 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    area_a = a[:, 2].clamp_min(0) * a[:, 3].clamp_min(0)
    area_b = b[:, 2].clamp_min(0) * b[:, 3].clamp_min(0)
    iw = (torch.minimum(ax1[:, None], bx1[None]) - torch.maximum(a[:, None, 0], b[None, :, 0]))
    ih = (torch.minimum(ay1[:, None], by1[None]) - torch.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    union = area_a[:, None] + area_b[None] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-30), 0.0)


def greedy_kept(scores, boxes, prob: float, iou_thr: float, capacity: int) -> list[int]:
    """The candidates greedy NMS keeps, in the order kept."""
    prob, iou_thr = _f32(prob), _f32(iou_thr)
    alive = scores > prob
    kept: list[int] = []
    while len(kept) < capacity and bool(alive.any()):
        best = int(torch.argmax(torch.where(alive, scores, -1.0)))  # the first of ties
        kept.append(best)
        alive &= iou(boxes, boxes[best:best + 1])[:, 0] <= iou_thr
        alive[best] = False
    return kept


def greedy_nms(scores, boxes, prob: float, iou_thr: float, capacity: int):
    """-> ``(rows (capacity, 5), mask (capacity,))``."""
    kept = greedy_kept(scores, boxes, prob, iou_thr, capacity)
    rows = torch.zeros((capacity, 5), device=scores.device)
    mask = torch.zeros(capacity, dtype=torch.bool, device=scores.device)
    if kept:
        idx = torch.tensor(kept, device=scores.device)
        rows[:len(kept), 0], rows[:len(kept), 1:] = scores[idx], boxes[idx]
        mask[:len(kept)] = True
    return rows, mask


def frame_rows(ref, params, frames_u8, model, precision: Precision = FLOAT32,
               block: int = 16) -> torch.Tensor:
    """The model's rows ``(F, N, ref.ROW)`` for ``(F, H, W, 3)`` uint8
    frames, in blocks of ``block`` frames."""
    out = []
    with torch.no_grad():
        for i in range(0, frames_u8.shape[0], block):
            x = frames_u8[i:i + block].float() / 255.0
            y = ref.forward(params, x, model, precision)
            out.append(y.reshape(y.shape[0], -1, ref.ROW))
    return torch.cat(out)
