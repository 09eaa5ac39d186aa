"""The port's decode+filter+NMS against fdtpu's Pallas kernel.

The same numpy inputs go to ``fdtpu_torch.kernels.nms`` (its plain version,
on the CPU) and to fdtpu's batched kernel K1 in interpret mode (and, at
B = 1, the per-image kernel K2). Masks and scores must be equal; coordinates
are integers after rounding and must agree to 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.core.nms import decode_filter_nms as xla_decode_filter_nms
from fdtpu.kernels import (
    pallas_decode_filter_nms,
    pallas_decode_filter_nms_batch,
)
from fdtpu.kernels import grid_decode_tables as jax_grid_tables
from fdtpu.kernels import ssd_output_decode_tables as jax_ssd_output_tables
from fdtpu_torch.core.nms import compact_boxes, decode_filter_nms
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import LAUNCHES

SSD_PRIORS = 4774  # SSDConfig's (60, 30, 15, 7) patch sizes
SSD_PRIORS_632 = 8204  # 79^2 + 39^2 + 19^2 + 9^2: past the kernel's shared-memory path
SSD_INPUT = {SSD_PRIORS: (480, 480), SSD_PRIORS_632: (632, 632)}


def grid_maps(rng, b, s, hot=6, size=(0.05, 0.95)):
    """Background cells below 0.45 confidence plus ``hot`` confident cells
    per image."""
    fm = rng.uniform(0, 0.45, size=(b, s, s, 5)).astype(np.float32)
    for i in range(b):
        for _ in range(hot):
            j, k = rng.integers(0, s, size=2)
            fm[i, j, k] = [rng.uniform(0.5, 1.0), *rng.uniform(*size, size=4)]
    return fm


def port(values, tables, prob, iou, cap):
    boxes, mask = knms.decode_filter_nms_batch(torch.from_numpy(values), tables, prob, iou, cap)
    return boxes.numpy(), mask.numpy()


def k1(values, tables, prob, iou, cap):
    boxes, mask = pallas_decode_filter_nms_batch(
        jnp.asarray(values), tables, prob, iou, cap, interpret=True
    )
    return np.asarray(boxes), np.asarray(mask)


def assert_same(got, want):
    (gb, gm), (wb, wm) = got, want
    assert gb.shape == wb.shape and gm.shape == wm.shape
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gb[..., 0], wb[..., 0])
    np.testing.assert_allclose(gb[..., 1:], wb[..., 1:], atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "s,size,b,cap",
    [(10, 480, 1, 16), (10, 480, 4, 64), (15, 320, 13, 64), (15, 320, 4, 16)],
)
def test_grid_matches_k1(s, size, b, cap):
    rng = np.random.default_rng(s * 1000 + b)
    vals = grid_maps(rng, b, s).reshape(b, s * s, 5)
    tables = knms.grid_decode_tables(s, (size, size))
    got = port(vals, tables, 0.5, 0.4, cap)
    assert_same(got, k1(vals, tables, 0.5, 0.4, cap))
    assert got[1].any()


def test_saturated_matches_k1():
    """More than ``capacity`` small, mostly disjoint boxes above threshold:
    every row is used and the greedy scan still equals K1's (no top-k
    pre-truncation)."""
    rng = np.random.default_rng(7)
    s, b, cap = 15, 4, 16
    fm = rng.uniform(0, 1, size=(b, s, s, 5)).astype(np.float32)
    fm[..., 3:] = rng.uniform(0.01, 0.06, size=(b, s, s, 2))
    vals = fm.reshape(b, s * s, 5)
    assert ((vals[..., 0] > 0.5).sum(axis=1) > cap).all()
    tables = knms.grid_decode_tables(s, (320, 320))
    got = port(vals, tables, 0.5, 0.5, cap)
    assert_same(got, k1(vals, tables, 0.5, 0.5, cap))
    assert got[1].all()


def test_tie_break_lowest_index():
    s = 15
    fm = np.zeros((1, s, s, 5), dtype=np.float32)
    fm[0, 0, 0] = [0.9, 0.1, 0.1, 0.05, 0.05]
    fm[0, 0, 1] = [0.9, 0.1, 0.1, 0.05, 0.05]  # same score, non-overlapping
    vals = fm.reshape(1, s * s, 5)
    tables = knms.grid_decode_tables(s, (480, 480))
    got = port(vals, tables, 0.5, 0.5, 8)
    assert_same(got, k1(vals, tables, 0.5, 0.5, 8))
    kept = compact_boxes(got[0][0], got[1][0])
    assert kept.shape[0] == 2 and kept[0, 1] < kept[1, 1]


def test_empty_map():
    s = 10
    vals = np.zeros((3, s * s, 5), dtype=np.float32)
    tables = knms.grid_decode_tables(s, (480, 480))
    got = port(vals, tables, 0.5, 0.5, 16)
    assert_same(got, k1(vals, tables, 0.5, 0.5, 16))
    assert not got[1].any() and not got[0].any()


def test_demo_thresholds_match_k1():
    """0.7 and 0.01 are not float32 values: both sides compare in float32."""
    rng = np.random.default_rng(3)
    s, b = 10, 4
    vals = grid_maps(rng, b, s, hot=12, size=(0.05, 0.4)).reshape(b, s * s, 5)
    tables = knms.grid_decode_tables(s, (480, 480))
    got = port(vals, tables, 0.7, 0.01, 16)
    assert_same(got, k1(vals, tables, 0.7, 0.01, 16))


def test_ssd_scale_matches_k1():
    """N = 4,774 SSD model-output rows (normalized, priors applied)."""
    rng = np.random.default_rng(11)
    b, n = 2, SSD_PRIORS
    vals = rng.uniform(0, 0.45, size=(b, n, 5)).astype(np.float32)
    for i in range(b):
        hot = rng.choice(n, size=40, replace=False)
        vals[i, hot, 0] = rng.uniform(0.5, 1.0, size=40)
        vals[i, hot, 3:] = rng.uniform(0.02, 0.2, size=(40, 2))
    got = port(vals, knms.ssd_output_decode_tables(n, (480, 480)), 0.5, 0.5, 32)
    want = k1(vals, jax_ssd_output_tables(n, (480, 480)), 0.5, 0.5, 32)
    assert_same(got, want)


def test_b1_matches_k2():
    rng = np.random.default_rng(5)
    s = 15
    vals = grid_maps(rng, 1, s).reshape(1, s * s, 5)
    tables = knms.grid_decode_tables(s, (320, 320))
    gb, gm = port(vals, tables, 0.5, 0.4, 32)
    wb, wm = pallas_decode_filter_nms(
        jnp.asarray(vals[0]), jax_grid_tables(s, (320, 320)), 0.5, 0.4, 32, interpret=True
    )
    assert_same((gb[0], gm[0]), (np.asarray(wb), np.asarray(wm)))


def test_matches_xla_twin_below_saturation():
    """Below capacity saturation fdtpu's XLA twin (top-k first, suppressed
    rows zeroed in place) keeps the same boxes in the same order."""
    rng = np.random.default_rng(9)
    s, b, size = 15, 4, (320, 320)
    fm = grid_maps(rng, b, s)
    boxes, mask = decode_filter_nms(torch.from_numpy(fm), s, size, 0.5, 0.4, 32)
    for i in range(b):
        wb, wm = xla_decode_filter_nms(jnp.asarray(fm[i]), s, size, 0.5, 0.4, 32)
        want = np.asarray(wb)[np.asarray(wm)]
        got = compact_boxes(boxes[i], mask[i])
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-4, rtol=0)


def test_core_wrapper_unbatched_and_batched():
    rng = np.random.default_rng(2)
    s = 10
    fm = torch.from_numpy(grid_maps(rng, 3, s))
    boxes, mask = decode_filter_nms(fm, s, (480, 480), 0.5, 0.5, 16)
    assert boxes.shape == (3, 16, 5) and mask.shape == (3, 16)
    for i in range(3):
        b1, m1 = decode_filter_nms(fm[i], s, (480, 480), 0.5, 0.5, 16)
        assert torch.equal(b1, boxes[i]) and torch.equal(m1, mask[i])


def test_wrapper_validates_and_cpu_never_counts():
    tables = knms.grid_decode_tables(10, (480, 480))
    before = LAUNCHES.copy()
    knms.decode_filter_nms_batch(torch.zeros(2, 100, 5), tables, 0.5, 0.5, 8)
    assert LAUNCHES == before
    with pytest.raises(TypeError):
        knms.decode_filter_nms_batch(torch.zeros(2, 100, 5, dtype=torch.float64), tables, 0.5, 0.5)
    with pytest.raises(ValueError):
        knms.decode_filter_nms_batch(torch.zeros(100, 5), tables, 0.5, 0.5)
    with pytest.raises(ValueError):
        knms.decode_filter_nms_batch(torch.zeros(2, 99, 5), tables, 0.5, 0.5)
    with pytest.raises(ValueError):
        knms.decode_filter_nms_batch(torch.zeros(2, 100, 5, device="meta"), tables, 0.5, 0.5)


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    from fdtpu_torch.kernels import build

    assert "-fmad=false" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path().parent == build.BUILD_DIR
    (tmp_path / "k.cu").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path()
    (tmp_path / "k.cu").write_text("// b\n")
    assert build.library_path() != first


def sorted_scan_model(values, tables, prob, iou, cap, chunk=32):
    """numpy model of the CUDA kernel's reformulation of the greedy loop:
    the eligible candidates (``conf > prob`` and ``conf > -0.5``) sorted by
    (score desc, index asc), then resolved in chunks of ``chunk``: a chunk
    row is dropped if a kept box or a kept earlier row of the chunk
    suppresses it (IoU not ``<= iou``, the kernel's arithmetic and operand
    order, all in float32), which the kernel settles by iterating that rule
    over the whole chunk until a round changes nothing; the scan stops at
    ``cap`` kept."""
    f32 = np.float32
    sx, ox, sy, oy = (np.asarray(t, f32) for t in tables[:4])
    ws, hs, prob, iou = (f32(t) for t in (*tables[4:], prob, iou))
    b, _, _ = values.shape
    boxes, mask = np.zeros((b, cap, 5), f32), np.zeros((b, cap), bool)
    for img, v in enumerate(values):
        conf = v[:, 0]
        x, y = v[:, 1] * sx + ox, v[:, 2] * sy + oy
        x0, y0 = np.rint(x), np.rint(y)
        x1, y1 = np.rint(x + v[:, 3] * ws), np.rint(y + v[:, 4] * hs)
        area = np.maximum(x1 - x0, f32(0)) * np.maximum(y1 - y0, f32(0))

        def suppresses(p, i):
            inter = (np.maximum(np.minimum(x1[i], x1[p]) - np.maximum(x0[i], x0[p]), f32(0))
                     * np.maximum(np.minimum(y1[i], y1[p]) - np.maximum(y0[i], y0[p]), f32(0)))
            union = (area[i] + area[p]) - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.where(union > 0, inter / union, f32(0))
            return ~(r <= iou)

        eligible = np.flatnonzero((conf > prob) & (conf > f32(-0.5)))
        key = conf[eligible] + f32(0)  # -0.0 + 0.0 = +0.0: the two zeros tie
        order = eligible[np.lexsort((eligible, -key))]
        kept = []
        for c0 in range(0, len(order), chunk):
            if len(kept) == cap:
                break
            q = order[c0 : c0 + chunk]
            removed = (suppresses(np.array(kept)[:, None], q[None, :]).any(0) if kept
                       else np.zeros(len(q), bool))
            by = np.tril(suppresses(q[None, :], q[:, None]), k=-1)  # [b, a]: earlier a kills b
            # a row is kept iff no kept earlier row kills it: iterate the
            # rule from every spared row until a round changes nothing
            keep = spared = ~removed
            while True:
                nxt = spared & ~(by & keep[None, :]).any(1)
                if (nxt == keep).all():
                    break
                keep = nxt
            kept.extend(q[keep][: cap - len(kept)])
        k = np.array(kept, dtype=np.int64)
        boxes[img, : len(k)] = np.stack([conf[k], x0[k], y0[k], x1[k] - x0[k], y1[k] - y0[k]], 1)
        mask[img, : len(k)] = True
    return boxes, mask


def scan_case_values(rng, b, n, case):
    """(B, N, 5) rows and the probability threshold of one map case."""
    v = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
    prob = 0.5
    if case == "saturated":  # small, mostly disjoint boxes: > capacity survive
        v[..., 3:] = rng.uniform(0.002, 0.03, size=(b, n, 2))
    elif case == "ties":  # three score levels, many exact ties
        v[..., 0] = rng.choice(np.float32([0.6, 0.75, 0.9]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "negative threshold":  # scores <= -0.5 end the scan
        v[..., 0] = rng.uniform(-1, -0.4, size=(b, n))
        v[..., 3:] *= 0.1
        prob = -0.7
    elif case == "signed zeros":  # +0.0 and -0.0 tie; the index decides
        v[..., 0] = rng.choice(np.float32([0.0, -0.0, -0.25, -0.6]), size=(b, n))
        v[..., 3:] *= 0.1
        prob = -0.3
    else:  # random
        v[..., 3:] *= 0.3
    return v, prob


@pytest.mark.parametrize("case", ["random", "saturated", "ties", "negative threshold",
                                  "signed zeros"])
@pytest.mark.parametrize("n,b,cap", [(100, 2, 32), (225, 2, 64), (SSD_PRIORS, 1, 128),
                                     (SSD_PRIORS_632, 1, 128)])
def test_sorted_chunked_scan_matches_k1(case, n, b, cap):
    """The kernel's reformulation (one sort, a resolve in chunks of 32
    against the kept list) equals fdtpu's greedy K1 in interpret mode, and
    the port's plain version bit for bit. At N = 8,204 (SSD at 632 px) the
    kernel takes its global-scratch path on the card, with the same
    algorithm."""
    rng = np.random.default_rng(n + len(case))
    vals, prob = scan_case_values(rng, b, n, case)
    if n in SSD_INPUT:
        tables, jtables = (knms.ssd_output_decode_tables(n, SSD_INPUT[n]),
                           jax_ssd_output_tables(n, SSD_INPUT[n]))
    else:
        s = int(round(n ** 0.5))
        tables = jtables = knms.grid_decode_tables(s, (480, 480) if s == 10 else (320, 320))
    got = sorted_scan_model(vals, tables, prob, 0.5, cap)
    assert_same(got, k1(vals, jtables, prob, 0.5, cap))
    want = port(vals, tables, prob, 0.5, cap)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].any()


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The kernel on the scan model's maps, and at eligible counts of
    capacity, one above it, and the rank sort's 256 against the bitonic
    sort's 257; outputs allocated over 0xFF (the kernel writes every
    entry). ``chip_smoke.py`` phase 3 runs the full sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)

    def same(vals, tables, prob, cap):
        junk = torch.empty(vals.shape[0] * cap * 6, dtype=torch.float32, device="cuda")
        junk.view(torch.uint8).fill_(0xFF)
        del junk
        gb, gm = knms.decode_filter_nms_batch(vals, tables, prob, 0.5, cap)
        wb, wm = knms.decode_filter_nms_reference(vals, tables, prob, 0.5, cap)
        assert torch.equal(gm, wm) and torch.equal(gb, wb)
        return gm

    for n, b, cap in ((100, 1, 128), (225, 128, 64), (SSD_PRIORS, 1, 128)):
        if n == SSD_PRIORS:
            cols = knms.ssd_output_decode_tables(n, (480, 480))
        else:
            cols = knms.grid_decode_tables(int(round(n ** 0.5)), (480, 480) if n == 100 else (320, 320))
        tables = (*(torch.from_numpy(c).cuda() for c in cols[:4]), *cols[4:])
        for case in ("random", "saturated", "ties", "negative threshold", "signed zeros"):
            vals, prob = scan_case_values(rng, b, n, case)
            same(torch.from_numpy(vals).cuda(), tables, prob, cap)
        for m in (cap, cap + 1, 256, 257):
            if m > n:
                continue
            vals = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
            vals[..., 0], vals[..., 3:] = 0.1, 0.0
            for i in range(b):
                vals[i, rng.choice(n, size=m, replace=False), 0] = 0.9
            gm = same(torch.from_numpy(vals).cuda(), tables, 0.5, cap)
            assert (gm.sum(-1) == min(m, cap)).all()
