"""YOLO-v1-style grid loss (``fdtpu/losses/yolo.py``).

Per cell, with occupancy ``o = gt_conf`` and ``S`` the grid size::

    xy_loss   = 3 o ((gt_x - pred_x)^2 + (gt_y - pred_y)^2)
    wh_loss   = 3 o ((sqrt(gt_w) - sqrt(pred_w))^2 + (sqrt(gt_h) - sqrt(pred_h))^2)
    conf_loss = (o + (1 - o) / S) (gt_conf - pred_conf)^2

summed over the map. ``compat_swap_xy=True`` pairs gt channel 1 with
prediction channel 2 and back, as the reference does (``YoloLoss.py:17-18``);
the default pairs them directly, as fdtpu does. Square roots take
``max(v, 1e-12)`` so that a prediction of exactly 0 has a finite gradient.
"""

from __future__ import annotations

import torch

COORD_WEIGHT = 3.0  # YoloLoss.py:24


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(v, 1e-12))


def yolo_loss(pred_fm: torch.Tensor, gt_fm: torch.Tensor, compat_swap_xy: bool = False):
    """Loss of ``(..., S, S, 5)`` predictions (post-sigmoid) against targets,
    summed over each map: a scalar for one ``(S, S, 5)`` pair, ``(B,)`` for a
    batch (``jax.vmap(fdtpu.losses.yolo_loss)``)."""
    s = pred_fm.shape[-2]
    gt_conf, pred_conf = gt_fm[..., 0], pred_fm[..., 0]
    gt_x, gt_y = gt_fm[..., 1], gt_fm[..., 2]
    if compat_swap_xy:
        pred_y, pred_x = pred_fm[..., 1], pred_fm[..., 2]
    else:
        pred_x, pred_y = pred_fm[..., 1], pred_fm[..., 2]
    gt_w, gt_h = gt_fm[..., 3], gt_fm[..., 4]
    pred_w, pred_h = pred_fm[..., 3], pred_fm[..., 4]

    occupied = gt_conf
    empty = 1.0 - gt_conf
    xy_loss = COORD_WEIGHT * occupied * ((gt_x - pred_x) ** 2 + (gt_y - pred_y) ** 2)
    wh_loss = COORD_WEIGHT * occupied * (
        (_sqrt(gt_w) - _sqrt(pred_w)) ** 2 + (_sqrt(gt_h) - _sqrt(pred_h)) ** 2
    )
    conf_loss = (occupied + empty * (1.0 / s)) * (gt_conf - pred_conf) ** 2
    return (xy_loss + wh_loss + conf_loss).sum(dim=(-2, -1))


def yolo_loss_batch(pred_fms, gt_fms, compat_swap_xy: bool = False, average: bool = False):
    """Loss over ``(B, S, S, 5)`` maps: the reference's un-normalized batch
    sum, or its mean over ``B`` with ``average=True``."""
    total = yolo_loss(pred_fms, gt_fms, compat_swap_xy).sum()
    if average:
        total = total / pred_fms.shape[0]
    return total
