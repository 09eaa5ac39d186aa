"""SSD loss: hard-negative-mining BCE + smooth-L1 (``fdtpu/losses/ssd.py``).

Every selection is a multiplicative mask, as in fdtpu. The reference's
semantics that fdtpu keeps:

* mining ranks each image's negatives by ``-log(confidence)`` on the
  detached scores and keeps all positives plus the top ``neg_pos_ratio *
  num_pos`` negatives, by a double argsort. Both sorts are stable, as
  ``jnp.argsort`` is: bf16 scores cast to float32 tie often, and an
  unstable sort would mine other negatives;
* classification is a sum-reduced BCE with a ``1e-7`` clamp against the
  labels rounded half to even (the docked ``1 - 0.001 ps`` rounds to 1);
* localisation is a sum-reduced smooth-L1 (beta 1) on the positive priors,
  written out as fdtpu does (``F.smooth_l1_loss`` orders its arithmetic
  otherwise);
* the total is ``(smooth_l1 + bce) / num_pos`` with ``num_pos`` summed over
  the batch; ``num_pos == 0`` divides by 1 (the reference would give NaN).
"""

from __future__ import annotations

import torch

_EPS = 1e-7  # the reference's CustomBCELoss epsilon


def hard_negative_mining(loss: torch.Tensor, labels: torch.Tensor,
                         neg_pos_ratio: float) -> torch.Tensor:
    """``(B, N)`` bool mask: every positive (``labels > 0``) and each
    image's ``neg_pos_ratio * num_pos`` negatives of highest ``loss``; a
    tie keeps the lower index."""
    pos_mask = labels > 0
    num_neg = pos_mask.sum(dim=1, keepdim=True) * neg_pos_ratio
    ranked = torch.where(pos_mask, -torch.inf, loss)
    # orders[b, n] = rank of prior n in descending-loss order
    indexes = torch.argsort(-ranked, dim=1, stable=True)
    orders = torch.argsort(indexes, dim=1, stable=True)
    return pos_mask | (orders < num_neg)


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber)."""
    abs_diff = diff.abs()
    return torch.where(abs_diff < beta, 0.5 * diff**2 / beta, abs_diff - 0.5 * beta)


def ssd_loss(
    confidence: torch.Tensor,
    predicted_locations: torch.Tensor,
    labels: torch.Tensor,
    gt_locations: torch.Tensor,
    neg_pos_ratio: float,
    bg_push: float = 0.0,
) -> torch.Tensor:
    """Batched SSD loss -> 0-d tensor.

    ``confidence`` ``(B, N)`` post-sigmoid scores; ``predicted_locations``
    and ``gt_locations`` ``(B, N, 4)`` with the priors applied; ``labels``
    ``(B, N)`` docked target confidences, positive where > 0. ``bg_push``
    (not in the reference, default off) weighs the BCE of the negatives
    that mining left out, which drives the untouched background scores
    down (fdtpu's quality extension).
    """
    mining_loss = -torch.log(confidence.detach().clamp(_EPS, 1.0))
    mask = hard_negative_mining(mining_loss, labels, neg_pos_ratio)

    conf = confidence.clamp(_EPS, 1.0 - _EPS)
    targets = torch.round(labels)
    bce = -(targets * torch.log(conf) + (1.0 - targets) * torch.log(1.0 - conf))
    classification_loss = torch.where(mask, bce, 0.0).sum()
    if bg_push:
        classification_loss = classification_loss + bg_push * torch.where(mask, 0.0, bce).sum()

    pos_mask = labels > 0
    loc_err = smooth_l1(predicted_locations - gt_locations)
    localisation_loss = (loc_err * pos_mask[..., None]).sum()
    return (localisation_loss + classification_loss) / pos_mask.sum().clamp_min(1)


def ssd_loss2(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The reference's unused YOLO-style SSD loss over ``(..., N, 5)`` prior
    rows, as fdtpu keeps it for parity: the grid loss's terms with
    ``no_object_weight = 1 / N``, predictions clamped to [0, 1] and the
    reference's x/y channel swap."""
    n = pred.shape[-2]
    pred = pred.clamp(0.0, 1.0)
    gt_conf, pred_conf = gt[..., 0], pred[..., 0]
    occupied = gt_conf
    empty = 1.0 - gt_conf

    def _sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    xy = occupied * ((gt[..., 1] - pred[..., 2]) ** 2 + (gt[..., 2] - pred[..., 1]) ** 2)
    wh = occupied * ((_sqrt(gt[..., 3]) - _sqrt(pred[..., 3])) ** 2
                     + (_sqrt(gt[..., 4]) - _sqrt(pred[..., 4])) ** 2)
    conf = (occupied + empty / n) * (gt_conf - pred_conf) ** 2
    return torch.sum(3.0 * (xy + wh) + conf)
