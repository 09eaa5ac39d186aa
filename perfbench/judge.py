"""The comparison that decides ``correct``: the numbers a cell's outputs
give against its plain reference, and their limits
(``limits/<cell>.json``).

Training, after the first three steps of the run (each taken by the
worst leaf; a leaf's gap is measured against the reference's norm of that
leaf or of the median leaf, whichever is larger):

* ``loss_gap``: ``|loss - loss_ref| / |loss_ref|``, the worst of the steps;
* ``grad_gap``: the first step's gradient as Adam received it, worked out
  from its first moment after the step (``m_1 = (1 - beta1) g``): the gap
  of ``|g|`` and ``|g_ref|``;
* ``box_grad_gap``: that gradient's box rows alone (the rows of the
  leaves that write box coordinates, the family's ``box_rows``, which the
  loss reads at the positives only, so that no mining choice moves them):
  each leaf's gap of norms against the larger of its norm and the median
  box leaf's, the root mean square over those leaves;
* ``change_gap``: the gap of the norms of each parameter's change over the
  three steps. Leaves whose reference gradient is under a thousandth of
  the median leaf's are left out (their change under Adam is round-off).

Serving, for each distinct answer (a frame's kept rows and mask), against
the reference's candidates of that frame (each kept row is matched, in
the answer's order, to the candidate not yet taken nearest to it: its
largest coordinate gap in pixels plus 500 times its score gap):

* ``box_gap_px``: the largest coordinate gap of a kept row to its match;
* ``score_gap``: the largest gap of a kept row's score to its match's;
* ``overlap``: the IoU of two kept rows above the IoU threshold, in the
  answer's own pixels: an exact check of NMS's rule, limit 0;
* ``kept_gap``: which candidates NMS kept, over all the distinct answers:
  the candidates kept by the answer (its rows' matches) or by greedy NMS
  of the reference's candidates, but not by both, as a share of those
  greedy NMS keeps. An answer that drops, adds or swaps a selection moves
  it; one that keeps nothing where the reference keeps something too;
* ``nms_gap``: how far the answer is from being greedy NMS of the
  reference's candidates: the larger of a kept row's reference score
  under the probability threshold and, for each eligible candidate left
  out (but one under 2 px wide or high, whose IoU a pixel's rounding
  decides), the least of its score above the threshold, its distance from
  being suppressed by a kept row (the IoU threshold less their IoU, each
  box grown by a pixel a side, or its score less the kept row's,
  whichever is larger), and, where the answer is full, its score above
  the lowest kept reference score;
* ``malformed``: answers whose rows are not compacted (kept rows first,
  zeros after), not in descending score order, or at or under the
  threshold by their own scores: an exact check, limit 0.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from perfbench.reference.serve import _f32, greedy_kept, iou

HERE = Path(__file__).resolve().parent


def limits(cell: str) -> dict[str, float]:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]


def verdict(numbers: dict[str, float], lim: dict[str, float]) -> tuple[bool, dict]:
    """-> ``(correct, {name: {"value", "limit"}})``; a number that is not
    finite, or a limit with no number, fails."""
    checks, ok = {}, True
    for name, limit in lim.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= bool(good)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


# -- training -----------------------------------------------------------------


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> tuple[float, float]:
    """-> the worst and the median leaf's gap of norms."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    median = float(torch.tensor(list(norms.values())).median())
    gaps = [abs(float(torch.linalg.vector_norm(prog[k].float())) - norms[k])
            / max(norms[k], median, 1e-30) for k in names]
    return max(gaps), float(torch.tensor(gaps).median())


def moving_leaves(first_grad_ref: dict) -> set[str]:
    """Leaves whose reference gradient is a thousandth of the median
    leaf's or more."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in first_grad_ref.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return {k for k, n in norms.items() if n >= 1e-3 * median}


def box_gap(prog: dict, ref: dict, rows: list[tuple[str, slice]]) -> float:
    """The root mean square over the ``(leaf, rows)`` of each one's gap of
    norms, against the larger of its reference norm and the median one's."""
    norms = [float(torch.linalg.vector_norm(ref[k][r].float())) for k, r in rows]
    median = float(torch.tensor(norms).median())
    gaps = [abs(float(torch.linalg.vector_norm(prog[k][r].float())) - n) / max(n, median, 1e-30)
            for (k, r), n in zip(rows, norms)]
    return (sum(g * g for g in gaps) / len(gaps)) ** 0.5


def train_numbers(prog: dict, ref: dict, box_rows: list[tuple[str, slice]]) -> dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (the first steps'), ``first_grad``
    and ``change`` by parameter name; ``box_rows``: the family's."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [float("inf")]
    grad, grad_median = _leaf_gaps(prog["first_grad"], ref["first_grad"])
    change, change_median = _leaf_gaps(prog["change"], ref["change"],
                                       moving_leaves(ref["first_grad"]))
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0], "grad_gap": grad,
            "grad_gap_median": grad_median,
            "box_grad_gap": box_gap(prog["first_grad"], ref["first_grad"], box_rows),
            "change_gap": change,
            "change_gap_median": change_median}


def train_details(prog: dict, ref: dict, top: int = 4) -> dict:
    """What lies under :func:`train_numbers`, for a look at the readings:
    each step's loss gap, and the leaves of the largest gradient and
    change gaps with their reference norms and the median leaf's."""
    out = {"loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                         for p, r in zip(prog["losses"], ref["losses"])]}
    moving = moving_leaves(ref["first_grad"])
    for key in ("first_grad", "change"):
        norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref[key].items()
                 if key == "first_grad" or k in moving}
        median = float(torch.tensor(list(norms.values())).median())
        gaps = sorted(((abs(float(torch.linalg.vector_norm(prog[key][k].float())) - n)
                        / max(n, median, 1e-30), k, n) for k, n in norms.items()), reverse=True)
        out[key] = {"median_norm": median, "worst": [[k, g, n] for g, k, n in gaps[:top]],
                    "median_gap": gaps[len(gaps) // 2][0]}
    out["left_out"] = sorted(set(ref["first_grad"]) - moving)
    return out


# -- serving ------------------------------------------------------------------


def malformed(rows: torch.Tensor, mask: torch.Tensor, prob: float) -> bool:
    k = int(mask.sum())
    if not bool(mask[:k].all()) or bool((rows[k:] != 0).any()):
        return True
    scores = rows[:k, 0]
    return bool((scores <= _f32(prob)).any()) or bool((scores[1:] > scores[:-1]).any())


SCORE_PX = 500.0  # a score gap of 0.01 weighs as a 5 px coordinate gap in the match
THIN_PX = 2.0  # a box thinner than this overlaps another wholly or not at all by a pixel


def _match(kept, ref_scores, ref_boxes) -> torch.Tensor:
    """Each kept row's candidate: in the answer's order, the candidate not
    yet taken nearest to it, by its largest coordinate gap (px) plus
    ``SCORE_PX`` times its score gap."""
    cost = (kept[:, None, 1:] - ref_boxes[None]).abs().amax(-1) \
        + SCORE_PX * (kept[:, None, 0] - ref_scores[None]).abs()
    match = []
    for k in range(kept.shape[0]):
        j = int(torch.argmin(cost[k]))
        match.append(j)
        cost[:, j] = float("inf")
    return torch.tensor(match, dtype=torch.long, device=kept.device)


def _grown(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes grown by a pixel on every side: each corner is rounded to a
    pixel, which the program's rounding may take to the other side, and a
    box a pixel thin then overlaps another wholly or not at all."""
    return torch.cat([boxes[:, :2] - 1.0, boxes[:, 2:].clamp_min(0.0) + 2.0], dim=-1)


def answer_numbers(rows, mask, ref_scores, ref_boxes, prob: float, iou_thr: float,
                   capacity: int) -> dict[str, float]:
    """The numbers of one answer (``rows`` ``(capacity, 5)``, ``mask``)
    against its frame's reference candidates; ``kept_diff`` and
    ``kept_ref`` are the counts :func:`serving_numbers` sums."""
    ref_kept = set(greedy_kept(ref_scores, ref_boxes, prob, iou_thr, capacity))
    prob, iou_thr = _f32(prob), _f32(iou_thr)
    kept = rows[mask]
    k = kept.shape[0]
    eligible = ref_scores > prob
    if k == 0:
        left = ref_scores[eligible] - prob
        return {"box_gap_px": 0.0, "score_gap": 0.0,
                "nms_gap": float(left.max()) if left.numel() else 0.0, "overlap": 0.0,
                "kept_diff": float(len(ref_kept)), "kept_ref": float(len(ref_kept))}
    match = _match(kept, ref_scores, ref_boxes)
    diff = len(ref_kept.symmetric_difference(match.tolist()))
    m_scores, m_boxes = ref_scores[match], ref_boxes[match]
    gap = (kept[:, 1:] - m_boxes).abs().amax(-1)
    nms = [float((prob - m_scores).max())]
    overlap = 0.0
    if k > 1:
        pair = iou(kept[:, 1:], kept[:, 1:])
        pair.fill_diagonal_(0.0)
        overlap = max(0.0, float(pair.max() - iou_thr))
    out = torch.ones_like(eligible)
    out[match] = False
    thin = (ref_boxes[:, 2] < THIN_PX) | (ref_boxes[:, 3] < THIN_PX)
    cand = torch.nonzero(eligible & out & ~thin).flatten()
    if cand.numel():
        s = ref_scores[cand]
        cover = torch.maximum(iou_thr - iou(_grown(ref_boxes[cand]), _grown(m_boxes)),
                              s[:, None] - m_scores[None]).amin(1)
        excuse = torch.minimum(s - prob, cover)
        if k >= capacity:
            excuse = torch.minimum(excuse, s - m_scores.min())
        nms.append(float(excuse.max()))
    return {"box_gap_px": float(gap.max()), "score_gap": float((kept[:, 0] - m_scores).abs().max()),
            "nms_gap": max(0.0, *nms), "overlap": overlap,
            "kept_diff": float(diff), "kept_ref": float(len(ref_kept))}


def serving_numbers(numbers: list[dict[str, float]]) -> dict[str, float]:
    """The answers' numbers together: the worst of each gap, and
    ``kept_gap`` from the summed counts."""
    if not numbers:
        return {}
    out = {name: max(n[name] for n in numbers) for name in numbers[0]
           if name not in ("kept_diff", "kept_ref")}
    ref = sum(n["kept_ref"] for n in numbers)
    out["kept_gap"] = sum(n["kept_diff"] for n in numbers) / max(ref, 1.0)
    return out
