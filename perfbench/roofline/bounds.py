"""The least time a kernel's work needs on the card: the larger of the
bytes it must move over the memory rate and its operations over the
float32 rate. Copied from the program's ``chip_smoke.py`` (``bound``,
``nms_bound`` and the shears' ``2 * nbytes(planes)``), so that the
yardstick stays where the program cannot move it.

Operations are counted a element: each multiply, add, compare, integer
op, conversion and transcendental is one.
"""

from __future__ import annotations

# K1: the filter's compare of every candidate; the decode of each eligible
# one; a greedy round's IoU test of each eligible one of its image
NMS_FILTER_OPS, NMS_DECODE_OPS, NMS_ROUND_OPS = 1, 17, 14
SHEAR_OPS = 4  # (1 - f) a + f b


def bound_s(nbytes: float, ops: float, peak: dict) -> float:
    return max(nbytes / peak["hbm_bytes"], ops / peak["f32_flops"])


def nms_bound_s(n: int, eligible: int, kept: int, capacity: int, peak: dict) -> float:
    """K1 on one image of ``n`` candidates, ``eligible`` of them above the
    threshold, ``kept`` kept: every candidate's row (5 float32) and its
    four decode-table entries read, the ``capacity`` rows (5 float32) and
    mask bytes written; the rounds are the kept rows and, where fewer than
    ``capacity`` are kept, the round that finds none alive."""
    rounds = kept + (1 if kept < capacity else 0)
    ops = n * NMS_FILTER_OPS + eligible * NMS_DECODE_OPS + rounds * eligible * NMS_ROUND_OPS
    nbytes = n * 5 * 4 + 4 * n * 4 + capacity * 5 * 4 + capacity
    return bound_s(nbytes, ops, peak)


def shear_bound_s(elements: int, itemsize: int, peak: dict) -> float:
    """One shear pass over planes of ``elements`` elements of ``itemsize``
    bytes: the planes read once and written once; 4 operations an
    element."""
    return bound_s(2 * elements * itemsize, SHEAR_OPS * elements, peak)
