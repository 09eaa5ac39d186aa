"""Targets and losses of the references: the reference repository's
semantics as the program keeps them, written over in plain PyTorch.

* Grid targets (``dataset.py:32-64``): a box goes to the cell of its
  top-left corner (the offset from the unclamped cell, the write to the
  clamped one), rows ``[conf, x_rel, y_rel, w / W, h / H]``, the last box
  of a cell wins.
* SSD targets: the same at every scale, ``x_rel`` times the patch size,
  the confidence docked by ``0.001 ps``; the localisation target has the
  priors applied.
* The YOLO loss (``YoloLoss.py``): ``3 o (dx^2 + dy^2) + 3 o ((sqrt w -
  sqrt w')^2 + (sqrt h - sqrt h')^2) + (o + (1 - o) / S) (c - c')^2`` per
  cell, summed over a map; square roots of ``max(v, 1e-12)``.
* The SSD loss (``SSDLoss.py``): hard-negative mining by two stable
  argsorts of ``-log(score)`` (every positive and the top ``ratio x
  positives`` negatives of each image), a sum-reduced BCE clamped at
  ``1e-7`` against rounded labels, a sum-reduced smooth-L1 on the
  positives, over the batch's positive count (at least 1).
"""

from __future__ import annotations

import torch


def _last_wins(vals: torch.Tensor, cell: torch.Tensor, mask: torch.Tensor, cells: int):
    """``(B, K, 5)`` rows into ``(B, cells, 5)``; where rows share a cell
    the highest ``k`` wins; invalid rows go nowhere."""
    b, k, _ = vals.shape
    out = torch.zeros((b, cells, 5), dtype=vals.dtype, device=vals.device)
    for j in range(k):  # in row order, so a later row overwrites
        written = out.scatter(1, cell[:, j, None, None].expand(b, 1, 5), vals[:, j:j + 1])
        out = torch.where(mask[:, j, None, None], written, out)
    return out


def grid_targets(boxes, mask, s: int, image_size: tuple[int, int]) -> torch.Tensor:
    """Pixel boxes ``(B, K, 5)`` rows ``[conf, x, y, w, h]`` -> ``(B, S,
    S, 5)``."""
    width, height = image_size
    xp, yp = width / s, height / s
    conf, x, y, w, h = boxes.unbind(-1)
    i, j = torch.floor(x / xp), torch.floor(y / yp)
    vals = torch.stack([conf, (x - i * xp) / xp, (y - j * yp) / yp, w / width, h / height], -1)
    cell = j.clamp(0, s - 1).long() * s + i.clamp(0, s - 1).long()
    return _last_wins(vals, cell, mask, s * s).reshape(boxes.shape[0], s, s, 5)


def ssd_targets(boxes, mask, patch_sizes, image_size: tuple[int, int]) -> torch.Tensor:
    """Pixel boxes -> ``(B, N, 5)`` prior targets (priors not applied)."""
    width, height = image_size
    conf = boxes[..., 0]
    x_n, y_n = boxes[..., 1] / width, boxes[..., 2] / height
    w_n, h_n = boxes[..., 3] / width, boxes[..., 4] / height
    parts = []
    for ps in patch_sizes:
        i, j = torch.floor(x_n * ps), torch.floor(y_n * ps)
        vals = torch.stack([conf - 0.001 * ps, (x_n - i / ps) * ps, (y_n - j / ps) * ps,
                            w_n, h_n], -1)
        cell = j.clamp(0, ps - 1).long() * ps + i.clamp(0, ps - 1).long()
        parts.append(_last_wins(vals, cell, mask, ps * ps))
    return torch.cat(parts, dim=1)


def yolo_loss(pred, gt) -> torch.Tensor:
    """``(B, S, S, 5)`` maps -> ``(B,)`` losses."""
    s = pred.shape[-2]

    def root(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    o = gt[..., 0]
    xy = 3.0 * o * ((gt[..., 1] - pred[..., 1]) ** 2 + (gt[..., 2] - pred[..., 2]) ** 2)
    wh = 3.0 * o * ((root(gt[..., 3]) - root(pred[..., 3])) ** 2
                    + (root(gt[..., 4]) - root(pred[..., 4])) ** 2)
    conf = (o + (1.0 - o) / s) * (gt[..., 0] - pred[..., 0]) ** 2
    return (xy + wh + conf).sum(dim=(-2, -1))


def ssd_loss(scores, locs, labels, gt_locs, neg_pos_ratio: float, bg_push: float = 0.0):
    """Scores ``(B, N)`` after the sigmoid, locations ``(B, N, 4)`` with
    the priors applied, labels ``(B, N)`` docked confidences."""
    eps = 1e-7
    pos = labels > 0
    mining = -torch.log(scores.detach().clamp(eps, 1.0))
    ranked = torch.where(pos, -torch.inf, mining)
    order = torch.argsort(torch.argsort(-ranked, dim=1, stable=True), dim=1, stable=True)
    keep = pos | (order < pos.sum(dim=1, keepdim=True) * neg_pos_ratio)
    conf = scores.clamp(eps, 1.0 - eps)
    target = torch.round(labels)
    bce = -(target * torch.log(conf) + (1.0 - target) * torch.log(1.0 - conf))
    cls = torch.where(keep, bce, 0.0).sum()
    if bg_push:
        cls = cls + bg_push * torch.where(keep, 0.0, bce).sum()
    d = locs - gt_locs
    ad = d.abs()
    huber = torch.where(ad < 1.0, 0.5 * d ** 2, ad - 0.5)
    loc = (huber * pos[..., None]).sum()
    return (loc + cls) / pos.sum().clamp_min(1)
