"""The port's decode+filter+NMS against fdtpu's Pallas kernel.

The same numpy inputs go to ``fdtpu_torch.kernels.nms`` (its plain version,
on the CPU) and to fdtpu's batched kernel K1 in interpret mode (and, at
B = 1, the per-image kernel K2). Masks and scores must be equal; coordinates
are integers after rounding and must agree to 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
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

SSD_PRIORS = 4774  # SSDConfig's (60, 30, 15, 7) patch sizes


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
    before = knms.decode_filter_nms_batch.launches
    knms.decode_filter_nms_batch(torch.zeros(2, 100, 5), tables, 0.5, 0.5, 8)
    assert knms.decode_filter_nms_batch.launches == before
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


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    for s, size, b, cap in ((10, 480, 1, 128), (15, 320, 128, 64)):
        vals = torch.from_numpy(rng.uniform(0, 1, size=(b, s * s, 5)).astype(np.float32)).cuda()
        tables = knms.grid_tables_on(s, (size, size), vals.device)
        gb, gm = knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)
        wb, wm = knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)
        assert torch.equal(gm, wm) and torch.equal(gb, wb)
