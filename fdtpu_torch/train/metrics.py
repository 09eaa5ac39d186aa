"""Detection metrics with the reference's semantics (``fdtpu/train/
metrics.py``).

* ``matches`` counts pairwise IoU-matrix entries over 0.5, not unique
  assignments (``ModelMeta.py:207``);
* recall = matches / num_gt, precision = matches / num_pred;
* a sample with no predictions contributes 0 to all three; with predictions
  but no gt, recall contributes 0;
* ``iou`` accumulates the sum of the whole IoU matrix;
* all three are means over the real samples; F1 comes from epoch-averaged
  precision and recall.

:func:`average_precision` is fdtpu's numpy implementation, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.core.boxes import box_iou, xywh_to_xyxy


def detection_metrics(pred_boxes, pred_mask, gt_boxes, gt_mask, sample_mask=None,
                      iou_match_threshold: float = 0.5) -> dict[str, torch.Tensor]:
    """Batched reference metrics over ``(B, P, 5)`` predictions
    ``[score, x, y, w, h]`` and ``(B, G, 5)`` ground truth, with their masks
    and an optional ``(B,)`` real-sample mask. Returns scalar tensors
    ``iou``, ``recall``, ``precision``."""
    b = pred_boxes.shape[0]
    if sample_mask is None:
        sample_mask = torch.ones((b,), dtype=torch.bool, device=pred_boxes.device)
    iou = box_iou(xywh_to_xyxy(gt_boxes[..., 1:5]), xywh_to_xyxy(pred_boxes[..., 1:5]))
    pair_mask = gt_mask[..., :, None] & pred_mask[..., None, :]
    iou = torch.where(pair_mask, iou, 0.0)

    num_gt = gt_mask.sum(-1)
    num_pred = pred_mask.sum(-1)
    matches = ((iou > iou_match_threshold) & pair_mask).sum(dim=(-2, -1))

    has_pred = (num_pred > 0) & sample_mask
    recall = torch.where(has_pred & (num_gt > 0), matches / num_gt.clamp_min(1), 0.0)
    precision = torch.where(has_pred, matches / num_pred.clamp_min(1), 0.0)
    iou_sum = torch.where(has_pred, iou.sum(dim=(-2, -1)), 0.0)

    denom = sample_mask.sum().clamp_min(1)
    return {
        "iou": iou_sum.sum() / denom,
        "recall": recall.sum() / denom,
        "precision": precision.sum() / denom,
    }


def f1_score(precision: float, recall: float) -> float:
    """Epoch F1 from averaged precision/recall (``ModelMeta.py:257``)."""
    denom = precision + recall
    return 0.0 if denom == 0 else 2 * precision * recall / denom


def average_precision(
    pred_boxes,
    pred_mask,
    gt_boxes,
    gt_mask,
    iou_threshold: float = 0.5,
):
    """Single-class AP@iou over a whole (host-side) eval set.

    Standard greedy matching: predictions sorted by score globally; each
    matches the best unmatched gt in its image with IoU over threshold.

    fdtpu's numpy implementation: all IoU matrices in one batched op, then
    a greedy scan over each image's score-ranked predictions. Tie-breaking:
    stable descending-score order (image index, then prediction index),
    first gt on equal IoU. Takes numpy arrays or tensors on any device.
    """
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a

    pred_boxes = np.asarray(host(pred_boxes), dtype=np.float64)
    pred_mask = np.asarray(host(pred_mask), dtype=bool)
    gt_boxes = np.asarray(host(gt_boxes), dtype=np.float64)
    gt_mask = np.asarray(host(gt_mask), dtype=bool)

    total_gt = int(gt_mask.sum())
    if total_gt == 0:
        return 0.0
    num_pred = int(pred_mask.sum())
    if num_pred == 0:
        return 0.0

    # batched IoU: (B, P, G), invalid pairs zeroed
    p, g = pred_boxes[..., 1:5], gt_boxes[..., 1:5]
    px0, py0 = p[..., 0], p[..., 1]
    px1, py1 = p[..., 0] + p[..., 2], p[..., 1] + p[..., 3]
    gx0, gy0 = g[..., 0], g[..., 1]
    gx1, gy1 = g[..., 0] + g[..., 2], g[..., 1] + g[..., 3]
    iw = np.clip(
        np.minimum(px1[:, :, None], gx1[:, None, :])
        - np.maximum(px0[:, :, None], gx0[:, None, :]), 0, None
    )
    ih = np.clip(
        np.minimum(py1[:, :, None], gy1[:, None, :])
        - np.maximum(py0[:, :, None], gy0[:, None, :]), 0, None
    )
    inter = iw * ih
    area_p = (px1 - px0) * (py1 - py0)
    area_g = (gx1 - gx0) * (gy1 - gy0)
    union = area_p[:, :, None] + area_g[:, None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    iou = np.where(pred_mask[:, :, None] & gt_mask[:, None, :], iou, 0.0)

    # per-image greedy matching in descending-score order (stable: ties go
    # by image index, then prediction index)
    b_dim = pred_boxes.shape[0]
    scores = np.where(pred_mask, pred_boxes[..., 0], -np.inf)
    tp = np.zeros_like(scores)
    for bi in range(b_dim):
        valid = np.flatnonzero(pred_mask[bi])
        if valid.size == 0:
            continue
        order = valid[np.argsort(-scores[bi, valid], kind="stable")]
        iou_b = iou[bi].copy()  # matched gts get erased as we go
        # preds whose best IoU can never clear the threshold are fp outright
        cand = order[iou_b[order].max(axis=1) > iou_threshold] \
            if gt_mask[bi].any() else order[:0]
        for pi in cand:
            row = iou_b[pi]
            gi = int(np.argmax(row))
            if row[gi] > iou_threshold:
                tp[bi, pi] = 1.0
                iou_b[:, gi] = -1.0  # gt consumed
    flat_scores = scores[pred_mask]
    flat_tp = tp[pred_mask]
    global_order = np.argsort(-flat_scores, kind="stable")
    tp_sorted = flat_tp[global_order]
    tp_cum = np.cumsum(tp_sorted)
    fp_cum = np.cumsum(1.0 - tp_sorted)
    recall = tp_cum / total_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # continuous AP (area under monotone precision envelope)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
