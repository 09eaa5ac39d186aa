"""The port's three-shear rotation against fdtpu's Pallas kernels, which run
here in interpret mode (``tests/test_rotate.py`` runs them the same way).

Same numpy images and angles on both sides. Tolerances:

* float32, on the 0-255 pixel scale: atol 1e-3. Both compute
  ``(1-f) a + f b`` per pass in float32; only the last bits of
  ``tan``/``sin`` and of fused multiply-adds may differ (measured 4.6e-5).
* bfloat16: within one bfloat16 step of fdtpu (1.0 at 128-255) and at
  least 99% of pixels exactly equal (measured: all equal).
* angle 0: exactly the input.
* ``rotate_boxes``: masks equal, boxes atol 1e-4.

K4's channel-stacked layout (``rotate_batch_transposed``) meets the same
bars. The sizes include 72, where ``S = 8 (mod 16)`` halves fdtpu's band,
and 160; the angles reach fdtpu's limit ``ROTATE_LIMIT_RAD`` on both sides,
where the reflect margin is tightest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.kernels import rotate_pallas as jrot
from fdtpu_torch.kernels import rotate as rot
from fdtpu_torch.kernels import LAUNCHES

ANGLES = np.float32([0.0, 0.2, -0.2, rot.ROTATE_LIMIT_RAD, -rot.ROTATE_LIMIT_RAD])
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fdtpu's kernels in interpret mode, jitted (about half the time of eager)
fdtpu_rotate = jax.jit(functools.partial(jrot.rotate_batch, interpret=True))
fdtpu_rotate_transposed = jax.jit(functools.partial(jrot.rotate_batch_transposed, interpret=True))


def images(s, n=len(ANGLES), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3)).astype(np.float32)


def check_against_fdtpu(got, want, dtype, x):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[0], torch.from_numpy(x[0]).to(DTYPES[dtype][1]).float())
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= 1e-3, d.max()
    else:
        assert d.max() <= 1.0, d.max()  # one bf16 step at 128-255
        assert (d == 0).mean() >= 0.99, (d == 0).mean()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [64, 72, 160])
def test_rotate_batch_matches_fdtpu(s, dtype):
    jdt, tdt = DTYPES[dtype]
    x = images(s, seed=s)
    want = fdtpu_rotate(jnp.asarray(x, jdt), jnp.asarray(ANGLES))
    got = rot.rotate_batch(torch.from_numpy(x).to(tdt), torch.from_numpy(ANGLES))
    assert got.dtype == tdt
    check_against_fdtpu(got, want, dtype, x)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [64, 72])
def test_rotate_batch_transposed_matches_fdtpu(s, dtype):
    jdt, tdt = DTYPES[dtype]
    x = images(s, seed=s + 1)
    want = fdtpu_rotate_transposed(jnp.asarray(x, jdt), jnp.asarray(ANGLES))
    got = rot.rotate_batch_transposed(torch.from_numpy(x).to(tdt), torch.from_numpy(ANGLES))
    check_against_fdtpu(got, want, dtype, x)


def test_u8_images_rotate_as_float32():
    x = images(64, n=2).astype(np.uint8)
    a = torch.tensor([0.0, 0.3])
    got = rot.rotate_batch(torch.from_numpy(x), a)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, rot.rotate_batch(torch.from_numpy(x).float(), a), rtol=0, atol=0)


def test_rotate_boxes_matches_fdtpu():
    rng = np.random.default_rng(1)
    boxes = np.zeros((3, 6, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(-10, 150, (3, 6, 2))
    boxes[..., 3:5] = rng.uniform(1, 60, (3, 6, 2))
    boxes[0, 0, 3:5] = 3.0  # under the min-area filter
    masks = rng.uniform(size=(3, 6)) > 0.2
    ang = np.float32([-0.3, 0.0, rot.ROTATE_LIMIT_RAD])
    wb, wm = jrot.rotate_boxes(jnp.asarray(boxes), jnp.asarray(masks), jnp.asarray(ang), 160)
    gb, gm = rot.rotate_boxes(torch.from_numpy(boxes), torch.from_numpy(masks),
                              torch.from_numpy(ang), 160)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-4, rtol=0)


def test_shears_on_cpu_use_the_plain_version_and_count_nothing():
    x = torch.from_numpy(images(64, n=2)).reshape(2, 64, 192)
    k = torch.tensor([0.1, -0.25])
    before = LAUNCHES.copy()
    torch.testing.assert_close(rot.shear_rows(x, k, 3, 0, 31.5),
                               rot.shear_rows_reference(x, k, 3, 0, 31.5), rtol=0, atol=0)
    torch.testing.assert_close(rot.shear_cols(x, k, 3, 31.5),
                               rot.shear_cols_reference(x, k, 3, 31.5), rtol=0, atol=0)
    assert LAUNCHES == before


def test_shear_semantics_on_a_ramp():
    """A lane ramp sheared by an integer offset moves by exactly that many
    pixels; taps beyond the plane read 0."""
    x = torch.arange(12, dtype=torch.float32).repeat(2, 1).reshape(1, 2, 12)  # c=3: 4 pixels
    out = rot.shear_rows_reference(x, torch.tensor([1.0]), 3, 0, 0.0)
    torch.testing.assert_close(out[0, 0], x[0, 0])  # row 0: t = 0
    torch.testing.assert_close(out[0, 1], torch.cat([x[0, 1, 3:], torch.zeros(3)]))  # t = 1
    half = rot.shear_cols_reference(x, torch.tensor([0.5]), 3, 0.0)  # t = lane//3 / 2
    assert half[0, 0, 3].item() == 0.5 * x[0, 0, 3].item() + 0.5 * x[0, 1, 3].item()


def test_wrappers_reject_what_the_kernel_does_not_take():
    k = torch.zeros(2)
    with pytest.raises(TypeError):
        rot.shear_rows(torch.zeros(2, 8, 24, dtype=torch.float64), k, 3, 0, 0.0)
    with pytest.raises(ValueError):
        rot.shear_rows(torch.zeros(2, 8, 24), torch.zeros(3), 3, 0, 0.0)
    with pytest.raises(ValueError):
        rot.shear_cols(torch.zeros(2, 8, 25), k, 3, 0.0)
    with pytest.raises(ValueError):
        rot.shear_cols(torch.zeros(2, 8, 24, device="meta"), torch.zeros(2, device="meta"), 3, 0.0)
    with pytest.raises(ValueError):
        rot.rotate_batch(torch.zeros(2, 60, 60, 3), k)
    with pytest.raises(ValueError):
        rot.rotate_batch(torch.zeros(2, 64, 64, 1), k)


@pytest.mark.gpu
def test_shear_kernels_match_plain_on_card():
    """Whole rotations at S = 200 and 320 with angles 0 and +-the limit, and
    the shears' edges: steep k (shear_cols staged in passes, or read from
    device memory), rows not a multiple of the band, lanes off the 16-byte
    grid, c = 1, c = 5 (a float32 second tap a vector away), K4's rows = 3
    row_mod, a row of one vector, views one
    element into their storage. Both dtypes,
    bit-equal. ``chip_smoke.py`` phase 7 runs the full sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    lim = rot.ROTATE_LIMIT_RAD
    for b, s in ((3, 200), (8, 320)):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.rand((b, s, s, 3), generator=g, device="cuda") * 255).to(dt)
            a = (torch.rand((b,), generator=g, device="cuda") * 2 - 1) * lim
            a[:3] = torch.tensor([0.0, lim, -lim])
            assert torch.equal(rot.rotate_batch(x, a), rot.rotate_batch_reference(x, a))
            assert torch.equal(rot.rotate_batch_transposed(x, a),
                               rot.rotate_batch_transposed_reference(x, a))
    ks = torch.tensor([0.0, np.sin(lim), -np.sin(lim), 0.9, -1.5, 3.0, 40.0],
                      dtype=torch.float32, device="cuda")
    for rows, lanes, c, row_mod in ((328, 984, 3, 0), (37, 45, 3, 0), (70, 1000, 1, 0),
                                    (336, 512, 1, 112), (48, 8, 1, 16), (40, 200, 5, 0)):
        for dt in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                flat = (torch.rand((len(ks) * rows * lanes + offset,), generator=g,
                                   device="cuda") * 255).to(dt)
                x = flat[offset:].view(len(ks), rows, lanes)
                ctr = ((row_mod or rows) - 1) / 2.0
                assert torch.equal(rot.shear_cols(x, ks, c, ctr),
                                   rot.shear_cols_reference(x, ks, c, ctr))
                assert torch.equal(rot.shear_rows(x, ks, c, row_mod, ctr),
                                   rot.shear_rows_reference(x, ks, c, row_mod, ctr))
