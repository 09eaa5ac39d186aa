"""The port's box math and grid decode against fdtpu's, on the same numpy
inputs. The operations are the same float32 elementwise steps on both
sides, so the results must be equal (IoU to 1 ulp-scale, 1e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.core import boxes as jax_boxes
from fdtpu.core.grid import decode_grid as jax_decode_grid
from fdtpu_torch.core import boxes, decode_grid


def random_xyxy(rng, n):
    xy = rng.uniform(0, 400, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(-5, 120, size=(n, 2)).astype(np.float32)  # some empty
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("fn", ["xywh_to_xyxy", "xyxy_to_xywh", "box_area"])
def test_conversions_match_fdtpu(fn):
    x = random_xyxy(np.random.default_rng(0), 64)
    got = getattr(boxes, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_box_iou_matches_fdtpu():
    rng = np.random.default_rng(1)
    a, b = random_xyxy(rng, 40), random_xyxy(rng, 30)
    a[3] = b[5] = [10, 10, 50, 60]  # one identical pair: IoU 1
    got = boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (40, 30)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert got[3, 5] == 1.0


def test_pad_boxes_matches_fdtpu():
    rows = np.random.default_rng(2).uniform(0, 100, size=(5, 5)).astype(np.float32)
    for cap in (3, 8):
        got, got_m = boxes.pad_boxes(rows, cap)
        want, want_m = jax_boxes.pad_boxes(rows, cap)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("s,size", [(10, (480, 480)), (15, (320, 320)), (7, (200, 160))])
def test_decode_grid_matches_fdtpu(s, size):
    fm = np.random.default_rng(s).uniform(0, 1, size=(3, s, s, 5)).astype(np.float32)
    got = decode_grid(torch.from_numpy(fm), s, size).numpy()
    want = np.asarray(jax_decode_grid(jnp.asarray(fm), s, size))
    assert got.shape == (3, s * s, 5)
    np.testing.assert_array_equal(got, want)
