"""On a card (``gpu``; skipped without one), RetinaFace-R50 at 840 px with
every ``cfg_re50`` width: K1's indexed op on its global-scratch path
(29,126 priors) bit-equal to its plain version, ``predict``'s landmarks
against the float32 plain reference
(``perfbench/reference/retinaface.py``), and the ``nms_scratch`` counter
at one a replay. No jax here, so the file runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_retinaface_card.py``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import Detector
from fdtpu_torch.utils import trace
from perfbench import data, program, reference, weights
from perfbench.reference.serve import frame_rows

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "retinaface-r50-840.json").read_text())
N = 29126
# A kept row's five points against its matched reference candidate's, in
# pixels: the bf16 forward moves a point by its offset's rounding (2^-8 of
# an offset of order 1, times 0.1 and a prior of up to 512 px: about 0.2
# px), and a row matched to a neighbour candidate of the same face (another
# anchor a stride away) by up to a few strides of the finest level (8 px).
POINT_PX = 24.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_rows(b: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """Normalised prior rows with about 60 of ``n`` candidates an image
    above 0.6, boxes of 2-40% of the side."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.rand((b, n, 5), generator=gen)
    rows[..., 0] = torch.where(torch.rand((b, n), generator=gen) < 120 / n, rows[..., 0], 0.1)
    rows[..., 3:] = 0.02 + 0.38 * rows[..., 3:]
    return rows.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_indexed_k1_on_scratch_equals_plain(card, b):
    rows = random_rows(b, N, card, seed=b)
    tables = knms.ssd_output_tables_on(N, (840, 840), card)
    assert N > knms.max_candidates(card.index or 0)
    scratch = LAUNCHES["decode_filter_nms_scratch"]
    got = knms.decode_filter_nms_batch(rows, tables, 0.6, 0.4, 750, indexed=True)
    assert LAUNCHES["decode_filter_nms_scratch"] == scratch + 1
    cpu_tables = tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in tables)
    want = knms.decode_filter_nms_reference(rows.cpu(), cpu_tables, 0.6, 0.4, 750, indexed=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    plain_op = knms.decode_filter_nms_batch(rows, tables, 0.6, 0.4, 750)
    assert all(torch.equal(g, w) for g, w in zip(got[:2], plain_op))
    kept = got[1].sum(1)
    assert bool((kept > 10).all())
    for i in range(b):
        k = int(kept[i])
        assert bool((got[2][i, :k] >= 0).all()) and bool((got[2][i, k:] == -1).all())


def served(card, seed: int = 2**35 + 3, frames: int = 4):
    """The configuration's Detector on weights from ``seed`` with the
    scores centred as the benchmark's stream cell centres them, the
    reference's float32 rows of the frames, and the frames."""
    pool, _, _ = data.faces(seed, "frames", frames, 840, 750, 12, card)
    w = weights.draw(reference.family("retinaface").param_specs(CONFIG["model"]), seed, card)
    with reference.strict_float32():
        weights.center_scores(reference.family("retinaface"), w, CONFIG["model"], pool, 50)
        rows = frame_rows(reference.family("retinaface"), w, pool, CONFIG["model"])
    d = CONFIG["detector"]
    det = Detector(program.module(CONFIG, w, card, train=False), d["probability_threshold"],
                   d["iou_threshold"], d["nms_capacity"], torch.bfloat16)
    return det, rows, [f for f in pool.cpu().numpy()]


@pytest.mark.gpu
def test_predict_landmarks_against_the_reference(card):
    ref = reference.family("retinaface")
    det, rows, frames = served(card)
    worst, kept_total = 0.0, 0
    for frame, r in zip(frames, rows):
        pred = det.predict(frame)
        norm, boxes, mask = pred
        points = pred.landmarks
        k = int(mask.sum())
        kept_total += k
        assert bool((points[k:] == 0).all())
        scores, cand = ref.candidates(r, CONFIG["model"])
        want = ref.landmarks_px(r, CONFIG["model"])
        cost = (boxes[:k, None, 1:] - cand[None]).abs().amax(-1) \
            + 500.0 * (boxes[:k, None, 0] - scores[None]).abs()
        match = cost.argmin(1)
        gap = (points[:k] - want[match]).abs().amax(-1)
        worst = max(worst, float(gap.max()) if k else 0.0)
    print(f"kept {kept_total} rows over {len(frames)} frames; worst point gap {worst} px")
    assert kept_total > 0 and worst <= POINT_PX


@pytest.mark.gpu
def test_nms_scratch_counter_one_a_replay(card):
    det, _, frames = served(card, frames=1)
    det.predict(frames[0])  # the capture
    (g,) = det._graphs.graphs.values()
    assert g.per_replay["decode_filter_nms"] == g.per_replay["decode_filter_nms_scratch"] == 1
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            det.predict(frames[0])
    assert trace.counters().get("nms_scratch") == 3
    trace.clear()
    start = LAUNCHES["decode_filter_nms_scratch"]
    det.predict(frames[0])  # tracing off: counted by the replay, not the tracer
    assert LAUNCHES["decode_filter_nms_scratch"] == start + 1
    assert trace.counters() == {}
