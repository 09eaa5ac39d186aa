"""Official WIDERFace evaluation protocol (easy/medium/hard mAP): a copy
of ``fdtpu/train/widerface_eval.py``, which is host-side numpy (scipy only
for :func:`load_official_gt`).

The reference repo never computes it (its ``run_validation_epoch.py``
reports loss/IoU/recall/precision only); this module re-implements the
official WIDERFace evaluation semantics (the published MATLAB/Python
toolkit protocol).

Protocol (semantics of the official toolkit, re-implemented fresh):

1. Detections are min-max **score-normalized over the whole split** so the
   1000-point threshold sweep spans them uniformly.
2. Per image, detections are matched **greedily in descending score order**
   to the ground-truth box of maximum IoU; a GT is matched at most once.
   A detection matching a non-kept ("ignored") GT — small/occluded/atypical
   faces outside the easy/medium/hard subset — is discarded: it counts
   neither as a proposal nor as recall. A detection matching an
   already-recalled kept GT stays a proposal (duplicates hurt precision).
3. PR points at 1000 score thresholds; recall denominator is the number of
   *kept* faces; AP is VOC-style all-points (precision envelope integral).
4. Toolkit-faithful quirks, kept deliberately: IoU uses the +1
   inclusive-pixel convention, and images with zero GT boxes or zero
   detections are skipped after counting their kept faces (false positives
   on GT-less images never count as proposals).

``tests/test_torch_entry.py`` holds this copy equal to fdtpu's.

Ground truth comes either from the official ``.mat`` files
(:func:`load_official_gt`, needs scipy + the ``eval_tools`` ground_truth
directory next to the dataset) or from any ``{image: boxes}`` mapping (the
synthetic-dataset tests fabricate one). Coordinates are pixel
``(x, y, w, h)`` with top-left origin, the dataset's native layout
(``fdtpu_torch/data/widerface.py``).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

__all__ = [
    "voc_ap",
    "norm_scores",
    "detections_to_official",
    "evaluate_split",
    "evaluate_widerface",
    "load_official_gt",
]


def detections_to_official(
    boxes: np.ndarray,
    mask: np.ndarray,
    input_size: tuple[int, int],
    original_size: tuple[int, int],
) -> np.ndarray:
    """Decode output -> official prediction rows.

    Args:
      boxes: ``(capacity, 5)`` rows ``[conf, x, y, w, h]`` in model-input
        pixels (the eval step / ``Detector.predict`` layout).
      mask: ``(capacity,)`` validity.
      input_size: model ``(width, height)``.
      original_size: source image ``(width, height)`` — detections are
        rescaled back to it, since the official ground truth lives in
        original pixels.

    Returns ``(n, 5)`` ``[x, y, w, h, score]`` float64.
    """
    boxes = np.asarray(boxes, np.float64)[np.asarray(mask, bool)]
    sx = original_size[0] / input_size[0]
    sy = original_size[1] / input_size[1]
    out = np.empty((boxes.shape[0], 5), np.float64)
    out[:, 0] = boxes[:, 1] * sx
    out[:, 1] = boxes[:, 2] * sy
    out[:, 2] = boxes[:, 3] * sx
    out[:, 3] = boxes[:, 4] * sy
    out[:, 4] = boxes[:, 0]
    return out


def _to_xyxy(b: np.ndarray) -> np.ndarray:
    out = b.astype(np.float64).copy()
    out[:, 2] = out[:, 0] + out[:, 2]
    out[:, 3] = out[:, 1] + out[:, 3]
    return out


def _iou_matrix(pred_xywh: np.ndarray, gt_xywh: np.ndarray) -> np.ndarray:
    """(N, M) IoU between xywh boxes, official **+1 inclusive-pixel
    convention**: the toolkit converts ``x2 = x1 + w`` and then measures
    every extent (widths, heights, intersections) as ``x2 - x1 + 1``
    (Faster-RCNN ``bbox_overlaps``; also the MATLAB ``boxoverlap.m``).
    Round 5 cross-check vs the clean-room transliteration
    (tests/widerface_official_transliteration.py) caught the continuous
    form previously used here as a protocol deviation."""
    p = _to_xyxy(pred_xywh)
    g = _to_xyxy(gt_xywh)
    lt = np.maximum(p[:, None, :2], g[None, :, :2])
    rb = np.minimum(p[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_p = (p[:, 2] - p[:, 0] + 1) * (p[:, 3] - p[:, 1] + 1)
    area_g = (g[:, 2] - g[:, 0] + 1) * (g[:, 3] - g[:, 1] + 1)
    union = area_p[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC all-points AP: area under the precision envelope over recall.

    ``recall`` must be non-decreasing (the threshold sweep produces that).
    """
    r = np.concatenate([[0.0], np.asarray(recall, np.float64), [1.0]])
    p = np.concatenate([[0.0], np.asarray(precision, np.float64), [0.0]])
    # precision envelope (right-to-left running max)
    for i in range(p.size - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def norm_scores(
    preds: Mapping[str, np.ndarray],
) -> dict[str, np.ndarray]:
    """Min-max normalize detection scores to [0, 1] over the WHOLE split
    (column 4 of each ``(N, 5)`` array), the official pre-pass."""
    all_scores = np.concatenate(
        [p[:, 4] for p in preds.values() if p.size], dtype=np.float64
    ) if any(p.size for p in preds.values()) else np.zeros((0,))
    if all_scores.size == 0:
        return {k: np.asarray(v, np.float64).reshape(-1, 5) for k, v in preds.items()}
    lo, hi = float(all_scores.min()), float(all_scores.max())
    span = (hi - lo) or 1.0
    out = {}
    for k, v in preds.items():
        v = np.asarray(v, np.float64).reshape(-1, 5).copy()
        if v.size:
            v[:, 4] = (v[:, 4] - lo) / span
        out[k] = v
    return out


def _image_eval(
    pred: np.ndarray,  # (N, 5) xywh+score, ANY order (sorted internally)
    gt: np.ndarray,  # (M, 4) xywh
    keep: np.ndarray,  # (M,) bool — True = counted face, False = ignore
    iou_thresh: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (scores desc, proposal flags, cumulative kept-recall per rank).

    Greedy protocol-faithful matching: walk detections in descending score;
    each detection takes its max-IoU GT if IoU >= thresh. Ignored-GT
    matches remove the detection from the proposal pool and retire that GT;
    kept-GT first matches recall it; later matches to the same GT remain
    ordinary proposals (duplicate penalty).
    """
    order = np.argsort(-pred[:, 4], kind="stable")
    pred = pred[order]
    n, m = pred.shape[0], gt.shape[0]
    proposal = np.ones(n, dtype=bool)
    cum_recall = np.zeros(n, dtype=np.int64)
    if m == 0:
        return pred[:, 4], proposal, cum_recall
    overlaps = _iou_matrix(pred[:, :4], gt)
    state = np.zeros(m, dtype=np.int8)  # 0 free, 1 recalled, -1 retired
    recalled = 0
    for h in range(n):
        row = overlaps[h]
        j = int(np.argmax(row))
        if row[j] >= iou_thresh:
            if not keep[j]:
                if state[j] == 0:
                    state[j] = -1
                proposal[h] = False
            elif state[j] == 0:
                state[j] = 1
                recalled += 1
        cum_recall[h] = recalled
    return pred[:, 4], proposal, cum_recall


def evaluate_split(
    preds: Mapping[str, np.ndarray],
    gts: Mapping[str, np.ndarray],
    keeps: Mapping[str, np.ndarray] | None = None,
    iou_thresh: float = 0.5,
    thresh_num: int = 1000,
    normalize: bool = True,
) -> dict:
    """Evaluate one difficulty split.

    Args:
      preds: ``{image_key: (N, 5) [x, y, w, h, score]}``.
      gts: ``{image_key: (M, 4) [x, y, w, h]}``; images missing from
        ``preds`` count as zero detections.
      keeps: ``{image_key: (M,) bool or index array}`` of counted faces for
        this difficulty; ``None`` counts every face.
      normalize: apply the official whole-split min-max score pre-pass.

    Returns ``{"ap", "precision", "recall", "thresholds", "num_faces"}``.
    """
    preds = {k: np.asarray(v, np.float64).reshape(-1, 5) for k, v in preds.items()}
    if normalize:
        preds = norm_scores(preds)
    thresholds = 1.0 - (np.arange(thresh_num, dtype=np.float64) + 1) / thresh_num

    count_faces = 0
    # accumulated (proposals, recalled) per threshold
    pr = np.zeros((thresh_num, 2), dtype=np.float64)
    for key, gt in gts.items():
        gt = np.asarray(gt, np.float64).reshape(-1, 4)
        if keeps is None:
            keep = np.ones(gt.shape[0], dtype=bool)
        else:
            raw = np.asarray(keeps[key])
            if raw.dtype == bool:
                keep = raw
            else:  # official mats store kept indices
                keep = np.zeros(gt.shape[0], dtype=bool)
                keep[raw.astype(np.int64).reshape(-1)] = True
        count_faces += int(keep.sum())
        pred = preds.get(key)
        # official control flow: an image with zero GT boxes OR zero
        # detections contributes only its kept-face count — false positives
        # on GT-less images never enter the proposal pool (published-toolkit
        # quirk, transliterated in tests/widerface_official_transliteration)
        if pred is None or pred.shape[0] == 0 or gt.shape[0] == 0:
            continue
        scores, proposal, cum_recall = _image_eval(pred, gt, keep, iou_thresh)
        # per-threshold: proposals among detections above threshold, and the
        # kept-recall at the lowest-ranked detection above threshold
        cum_prop = np.cumsum(proposal)
        # index of last detection with score >= t, per threshold (-1 if none)
        idx = np.searchsorted(-scores, -thresholds, side="right") - 1
        has = idx >= 0
        pr[has, 0] += cum_prop[idx[has]]
        pr[has, 1] += cum_recall[idx[has]]

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pr[:, 0] > 0, pr[:, 1] / pr[:, 0], 0.0)
        recall = pr[:, 1] / max(count_faces, 1)
    ap = voc_ap(recall, precision)
    return {
        "ap": ap,
        "precision": precision,
        "recall": recall,
        "thresholds": thresholds,
        "num_faces": count_faces,
    }


def evaluate_widerface(
    preds: Mapping[str, np.ndarray],
    gt_dir: str,
    iou_thresh: float = 0.5,
) -> dict[str, float]:
    """Full official val evaluation: ``{"easy": AP, "medium": AP, "hard": AP}``.

    ``gt_dir`` is the official ``ground_truth`` directory containing
    ``wider_face_val.mat`` + ``wider_{easy,medium,hard}_val.mat``.
    """
    out = {}
    for setting in ("easy", "medium", "hard"):
        gts, keeps = load_official_gt(gt_dir, setting)
        out[setting] = evaluate_split(
            preds, gts, keeps, iou_thresh=iou_thresh
        )["ap"]
    return out


def write_official_predictions(
    preds: Mapping[str, np.ndarray], out_dir: str
) -> int:
    """Write predictions in the official toolkit's submission layout —
    ``<out_dir>/<event>/<file>.txt`` with a name line, a count line, then
    ``x y w h score`` rows — so results can be cross-checked with the
    external evaluator. Returns the number of files written."""
    n = 0
    for key, det in preds.items():
        det = np.asarray(det, np.float64).reshape(-1, 5)
        event, name = key.split("/", 1)
        d = os.path.join(out_dir, event)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{name}.txt"), "w") as f:
            f.write(f"{name}\n{det.shape[0]}\n")
            for row in det:
                f.write(
                    f"{row[0]:.3f} {row[1]:.3f} {row[2]:.3f} "
                    f"{row[3]:.3f} {row[4]:.5f}\n"
                )
        n += 1
    return n


def load_official_gt(
    gt_dir: str, setting: str
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Parse the official ground-truth ``.mat`` pair into
    ``(gts, keeps)`` keyed by ``"<event>/<file>"`` (no extension).

    Requires scipy and the official files; raises ``FileNotFoundError``
    with the expected layout otherwise (the container has no egress — see
    ``fdtpu_torch/data/widerface.py`` for the download table).
    """
    from scipy.io import loadmat  # deferred: only the real-data path needs it

    gt_path = os.path.join(gt_dir, "wider_face_val.mat")
    split_path = os.path.join(gt_dir, f"wider_{setting}_val.mat")
    for p in (gt_path, split_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"official WIDERFace eval file missing: {p} (download the "
                "eval_tools ground_truth directory alongside the dataset)"
            )
    gt_mat = loadmat(gt_path)
    split_mat = loadmat(split_path)
    events = gt_mat["event_list"]
    files = gt_mat["file_list"]
    boxes = gt_mat["face_bbx_list"]
    keep_lists = split_mat["gt_list"]

    gts: dict[str, np.ndarray] = {}
    keeps: dict[str, np.ndarray] = {}
    for ei in range(events.shape[0]):
        event = str(events[ei][0][0])
        flist = files[ei][0]
        blist = boxes[ei][0]
        klist = keep_lists[ei][0]
        for fi in range(flist.shape[0]):
            key = f"{event}/{str(flist[fi][0][0])}"
            bbx = np.asarray(blist[fi][0], np.float64).reshape(-1, 4)
            raw_keep = np.asarray(klist[fi][0]).reshape(-1)
            keep = np.zeros(bbx.shape[0], dtype=bool)
            if raw_keep.size:
                keep[raw_keep.astype(np.int64) - 1] = True  # 1-based mat
            gts[key] = bbx
            keeps[key] = keep
    return gts, keeps
