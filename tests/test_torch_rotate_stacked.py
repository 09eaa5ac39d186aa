"""K4, fdtpu's row shear on channel-stacked planes (``rotate_pallas._shear``,
the kernel of ``rotate_batch_transposed``), against the port's plain
``shear_rows`` with ``c = 1``: the function the port's CUDA kernel is held
to, bit for bit, on the card. fdtpu's kernel runs here in interpret mode.

Both geometries of fdtpu's transposed rotation at S = 64 (pad 24, Hp = 112,
guards g1 = 72 and g2 = 24, so lanes are whole 128-lane tiles):

* horizontal: rows = 3 Hp (channels stacked), ``row_mod = Hp``, center
  ``pad + (S - 1) / 2``, ``|k| <= tan(limit / 2)``;
* vertical, on the transpose: rows = Wp + 2 g1, ``row_mod = 0``, center
  ``g1 + pad + (S - 1) / 2``, ``|k| <= sin(limit)``.

k in {0, +-k_max, 0.1}, one plane each, same numpy planes of 0-255 integers
on both sides. fdtpu rolls, so a tap past a row's end wraps around where the
port reads 0: only lanes whose two taps both lie inside the row are
compared. Tolerances as ``tests/test_torch_rotate.py``: float32 atol 1e-3 on
the 0-255 scale (both compute ``(1-f) a + f b`` in float32; fdtpu sums its
zero-weighted slices too, and XLA may fuse), bfloat16 within one bfloat16
step (1.0 at 128-255) with at least 99% of values equal (measured: float32
1.5e-5; bfloat16 99.95% and 99.97% equal, the rest one step apart).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.kernels import rotate_pallas as jrot
from fdtpu_torch.kernels import rotate as rot
from fdtpu_torch.kernels import LAUNCHES

S = 64
PAD = rot._pad_for(S)  # 24
HP = S + 2 * PAD  # 112
G1, G2 = 72, 24  # rotate_pallas.rotate_batch_transposed's lane guards at S = 64
CY = PAD + (S - 1) / 2.0
LIM = rot.ROTATE_LIMIT_RAD
# (rows, lanes, row_mod, center, k_max)
GEOMETRY = {
    "horizontal": (3 * HP, HP + 2 * G1, HP, CY, math.tan(LIM / 2)),
    "vertical": (HP + 2 * G1, 3 * HP + 2 * G2, 0, G1 + CY, math.sin(LIM)),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def fdtpu_shear(k_max: float, row_mod: int, row_center: float):
    return jax.jit(functools.partial(jrot._shear, k_max=k_max, row_mod=row_mod,
                                     row_center=row_center, interpret=True))


def inside_taps(k: np.ndarray, rows: int, lanes: int, row_mod: int, center: float) -> np.ndarray:
    """(K, R, L) mask of the lanes whose taps l + n and l + n + 1 both lie in
    the row, n the float32 floor of both sides' shift."""
    rr = np.arange(rows) % row_mod if row_mod else np.arange(rows)
    t = k[:, None] * (rr.astype(np.float32) - np.float32(center))
    n = np.floor(t).astype(np.int64)[..., None]
    lane = np.arange(lanes)
    return (lane + n >= 0) & (lane + n + 1 < lanes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
def test_stacked_shear_matches_fdtpu(geometry, dtype):
    rows, lanes, row_mod, center, k_max = GEOMETRY[geometry]
    jdt, tdt = DTYPES[dtype]
    k = np.float32([0.0, k_max, -k_max, 0.1])
    planes = np.random.default_rng(rows + lanes).integers(0, 256, (len(k), rows, lanes))
    planes = planes.astype(np.float32)

    want = fdtpu_shear(k_max, row_mod, center)(jnp.asarray(planes, jdt), jnp.asarray(k))
    got = rot.shear_rows_reference(torch.from_numpy(planes).to(tdt), torch.from_numpy(k), 1,
                                   row_mod, rot._f32(center))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)

    mask = inside_taps(k, rows, lanes, row_mod, center)
    assert mask.mean() > 0.8, mask.mean()  # the comparison covers most of each plane
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got[0], torch.from_numpy(planes[0]).to(tdt).float())  # k = 0
    d = np.abs(got - want)[mask]
    if dtype == "float32":
        assert d.max() <= 1e-3, d.max()
    else:
        assert d.max() <= 1.0, d.max()  # one bf16 step at 128-255
        assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_stacked_launches_stay_zero_on_cpu():
    """K4's layout on CPU tensors runs the plain version: no launch count
    moves, ``LAUNCHES["shear_rows_stacked"]`` (its ``c = 1`` calls) among
    them, for ``shear_rows`` alone or through ``rotate_batch_transposed``."""
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)).astype(np.float32))
    a = torch.tensor([0.1, -0.3])
    before = LAUNCHES.copy()
    planes = x.permute(0, 3, 1, 2).reshape(2, 3 * 64, 64).contiguous()
    torch.testing.assert_close(rot.shear_rows(planes, a, 1, 64, 31.5),
                               rot.shear_rows_reference(planes, a, 1, 64, 31.5), rtol=0, atol=0)
    torch.testing.assert_close(rot.rotate_batch_transposed(x, a),
                               rot.rotate_batch_transposed_reference(x, a), rtol=0, atol=0)
    assert LAUNCHES == before
