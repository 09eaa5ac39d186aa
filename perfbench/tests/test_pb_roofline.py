"""The bound arithmetic on cases worked by hand."""

import pytest

from perfbench.roofline import bounds
from perfbench.roofline.peaks import peaks

H100 = peaks("NVIDIA H100 80GB HBM3")


def test_bound_takes_the_larger():
    assert bounds.bound_s(3.35e9, 0, H100) == pytest.approx(1e-3)
    assert bounds.bound_s(0, 67e9, H100) == pytest.approx(1e-3)
    assert bounds.bound_s(3.35e9, 134e9, H100) == pytest.approx(2e-3)


def test_shear_planes():
    """b8 float32 planes of 768 x 768 (480 px and its 144 px margins),
    three channels: 56.6 MB read and written; bfloat16 half that."""
    elements = 8 * 768 * 768 * 3
    assert bounds.shear_bound_s(elements, 4, H100) == pytest.approx(2 * elements * 4 / 3.35e12)
    assert bounds.shear_bound_s(elements, 2, H100) == pytest.approx(2 * elements * 2 / 3.35e12)


def test_nms_by_bytes_and_by_operations():
    # 100 candidates, none eligible: 100 rows + 4 tables read, 128 rows and
    # mask bytes written; one round that finds none
    nbytes = 100 * 20 + 4 * 100 * 4 + 128 * 20 + 128
    assert bounds.nms_bound_s(100, 0, 0, 128, H100) == pytest.approx(nbytes / 3.35e12)
    # 4,774 candidates, 2,400 eligible, a full answer: 128 rounds
    ops = 4774 + 2400 * 17 + 128 * 2400 * 14
    assert bounds.nms_bound_s(4774, 2400, 128, 128, H100) == pytest.approx(ops / 67e12)
