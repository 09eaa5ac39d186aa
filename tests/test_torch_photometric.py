"""The port's fused photometric chain (K5) against fdtpu's Pallas kernel in
interpret mode, and the fused exact-k route against fdtpu's
``FDTPU_PALLAS_AUGMENT=1`` route with fdtpu's draws and seeds injected.

Tolerances:

* ``photometric_reference`` against ``pallas_photometric_batch``: atol 1e-6
  on the [0, 1] output, noise included (the murmur3 bits are integer
  arithmetic and equal; what differs is where XLA rounds: it may fuse a
  multiply and an add, and its log, cos and division by 255 round
  differently from PyTorch's by an ulp). Measured: at most 3e-7.
* the fused exact-k route: images atol 1e-5 on [0, 1], boxes and masks
  equal. The float32 crop contracts in another summation order than
  ``jax.image`` (``tests/test_torch_augment.py``: 1e-3 on the 0-255
  scale), and the rotation's float32 taps differ by up to 4.6e-5 on 0-255
  (``tests/test_torch_rotate.py``); the blurs average such differences.
  Measured: at most 3.8e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.data import augment as jaug
from fdtpu.kernels import augment_pallas as jpal
from fdtpu_torch.data import augment as aug
from fdtpu_torch.kernels import photometric as kp
from fdtpu_torch.kernels import LAUNCHES

ATOL = 1e-6
ROUTE_ATOL = 1e-5
S = 48  # the route's image side (rotation takes a multiple of 8)


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def table(rng, b, alpha=1.0, beta=0.0, sigma=0.0, glass=0.0, motion=0.0, bins=None):
    sc = np.zeros((b, 8), np.float32)
    sc[:, kp.ALPHA], sc[:, kp.BETA], sc[:, kp.NOISE_SIGMA] = alpha, beta, sigma
    sc[:, kp.GLASS], sc[:, kp.MOTION] = glass, motion
    sc[:, kp.MDX] = rng.integers(0, 16, b) if bins is None else bins
    return sc


def both(imgs, sc, seeds):
    want = np.asarray(jpal.pallas_photometric_batch(
        jnp.asarray(imgs), jnp.asarray(sc), jnp.asarray(seeds), True))
    got = kp.photometric_reference(torch.from_numpy(imgs), torch.from_numpy(sc),
                                   torch.from_numpy(seeds))
    return got.numpy(), want


def inputs(rng, b, h, w):
    imgs = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, 3 * b).astype(np.int32)
    return imgs, seeds


CASES = {
    "identity": dict(),
    "brightness_contrast": dict(alpha=np.float32([0.83, 1.17]), beta=np.float32([-41.5, 30.25])),
    "noise_seed_0": dict(sigma=np.float32([3.2, 19.9]), seeds=0),
    "noise_seed_max": dict(sigma=np.float32([3.2, 19.9]), seeds=2**31 - 2),
    "noise_random_seeds": dict(sigma=np.float32([11.0, 7.5])),
    "glass": dict(glass=1.0),
    "all_gates": dict(alpha=np.float32([1.1, 0.9]), beta=np.float32([12.0, -7.0]),
                      sigma=np.float32([14.0, 5.0]), glass=1.0, motion=1.0),
}


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_fdtpu_kernel(case, hw):
    rng = np.random.default_rng(sorted(CASES).index(case))
    imgs, seeds = inputs(rng, 2, *hw)
    kw = dict(CASES[case])
    if "seeds" in kw:
        seeds[:] = kw.pop("seeds")
    got, want = both(imgs, table(rng, 2, **kw), seeds)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)])
@pytest.mark.parametrize("bins", [range(0, 8), range(8, 16)])
def test_motion_bins_match_fdtpu_kernel(bins, hw):
    """Each of the 16 direction bins, eight to a call."""
    rng = np.random.default_rng(bins[0] + hw[0])
    imgs, seeds = inputs(rng, 8, *hw)
    sc = table(rng, 8, motion=1.0, bins=np.float32(list(bins)))
    got, want = both(imgs, sc, seeds)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_noise_is_the_seeds_field():
    """sigma 1 on a flat image: the output minus the image is the noise
    field, the same for the same seed in any plane, and standard normal."""
    b, h, w = 4, 64, 64
    imgs = torch.full((b, h, w, 3), 128.0)
    sc = torch.from_numpy(table(np.random.default_rng(0), b, sigma=1.0))
    seeds = torch.arange(3 * b, dtype=torch.int32) % 5
    out = kp.photometric_reference(imgs, sc, seeds) * 255.0 - 128.0
    field = kp.noise_field(seeds, h, w).reshape(b, 3, h, w).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), field.numpy(), atol=1e-4, rtol=0)
    assert torch.equal(field[0, ..., 0], field[1, ..., 2])  # planes 0 and 5: seed 0
    assert not torch.equal(field[0, ..., 0], field[0, ..., 1])
    assert abs(field.mean().item()) < 0.05 and abs(field.std().item() - 1.0) < 0.05


def test_tables_match_fdtpu():
    assert kp.G5 == jpal._G5
    for got, want in zip(kp.MOTION_TAPS, jpal._MOTION_TAPS, strict=True):
        assert [(dy, dx, np.float32(wk)) for dy, dx, wk in got] == \
            [(dy, dx, np.float32(wk)) for dy, dx, wk in want]


def test_wrapper_dispatch_and_validation():
    """A CPU tensor runs the plain version and counts nothing; any other
    device than the card raises instead of falling back; malformed inputs
    raise."""
    rng = np.random.default_rng(1)
    imgs, seeds = inputs(rng, 2, 32, 32)
    sc = table(rng, 2, glass=1.0)
    x, s, sd = torch.from_numpy(imgs), torch.from_numpy(sc), torch.from_numpy(seeds)
    before = LAUNCHES.copy()
    assert torch.equal(kp.photometric_batch(x, s, sd), kp.photometric_reference(x, s, sd))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        kp.photometric_batch(x.to("meta"), s.to("meta"), sd.to("meta"))
    with pytest.raises(TypeError):
        kp.photometric_batch(x.to(torch.bfloat16), s, sd)
    with pytest.raises(ValueError):
        kp.photometric_batch(x, s[:, :7], sd)
    with pytest.raises(ValueError):
        kp.photometric_batch(x, s, sd.long())
    with pytest.raises(ValueError):
        kp.photometric_batch(x[..., :1], s, sd)


# -- the fused exact-k route ----------------------------------------------------------


def route_batch(b, seed=0, n=4):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(0, 36, (b, n, 2)).round()
    boxes[..., 3:5] = rng.uniform(2, 20, (b, n, 2)).round()
    masks = rng.uniform(size=(b, n)) > 0.3
    return imgs, boxes, masks


def fdtpu_fused_draws(key, b, positional_crop):
    """Every draw of fdtpu's exact-k path with ``FDTPU_PALLAS_AUGMENT=1``
    and rotation (``augment.py:578-676``)."""
    kperm, kcrop, kpost = jax.random.split(key, 3)
    k = round(jaug.P_CROP * b)
    wins = [jaug._sample_crop(jax.random.split(ck, 5), S, S, gate=False)
            for ck in jax.random.split(kcrop, k)]
    rows = np.arange(k) if positional_crop else np.asarray(jax.random.permutation(kperm, b)[:k])
    krsel, kang = jax.random.split(jax.random.fold_in(key, 17))
    rk = round(jaug.P_ROTATE * b)
    lim = jnp.deg2rad(jaug.ROTATE_LIMIT_DEG)
    photo_start = (k if positional_crop and k + sum(jaug._photometric_counts(b)) <= b
                   else None)
    scalars, seeds, sels = jaug._sample_photometric_params_exact_k(kpost, b, start=photo_start)
    return aug.ExactKDraws(
        crop_rows=torch.from_numpy(np.array(rows)),
        crop_window=tuple(t32([float(w[i]) for w in wins]) for i in range(4)),
        scalars=t32(scalars), sels=tuple(torch.from_numpy(np.array(s)) for s in sels),
        noise=None, photo_start=photo_start, positional_flip=False,
        rotate_rows=torch.from_numpy(np.array(jax.random.permutation(krsel, b)[:rk])),
        angles=t32(jax.random.uniform(kang, (rk,), minval=-lim, maxval=lim)),
        seeds=torch.from_numpy(np.array(seeds)),
    )


@pytest.mark.parametrize("positional_crop", [True, False])
def test_fused_route_matches_fdtpu(positional_crop, monkeypatch):
    """b = 16, 48 px: crop, rotation, flip and the fused photometric chain
    in float32, against fdtpu's route through its Pallas kernel."""
    monkeypatch.setenv("FDTPU_PALLAS_AUGMENT", "1")
    key = jax.random.PRNGKey(3 + positional_crop)
    imgs, boxes, masks = route_batch(16, seed=positional_crop)
    draws = fdtpu_fused_draws(key, 16, positional_crop)
    assert (draws.scalars[:, kp.NOISE_SIGMA] > 0).sum() == 3
    fdtpu = jax.jit(lambda k, i, b, m: jaug.augment_batch_fast(
        k, i, b, m, rotate=True, positional_crop=positional_crop))
    wi, wb, wm = fdtpu(key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(masks))
    gi, gb, gm = aug.apply_exact_k(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                   torch.from_numpy(masks), draws, fused_photometric=True)
    assert gi.dtype == torch.float32 and wi.dtype == jnp.float32
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=ROUTE_ATOL, rtol=0)


def test_fused_route_draws_and_entry_point():
    """The fused route draws seeds and a Bernoulli flip (no positional
    flip), takes float32 images out, repeats with its seed, and changes
    nothing below B = 16."""
    gen = torch.Generator().manual_seed(0)
    d = aug.sample_exact_k(gen, 32, S, S, "cpu", rotate=True, positional_crop=True,
                           fused_photometric=True)
    assert d.noise is None and d.seeds.dtype == torch.int32 and d.seeds.shape == (96,)
    assert 0 <= int(d.seeds.min()) and int(d.seeds.max()) < 2**31 - 1
    assert not d.positional_flip
    assert d.scalars[:, kp.FLIP].tolist() != [i % 2 for i in range(32)]
    x, bx, m = (torch.from_numpy(a) for a in route_batch(16, seed=2))
    with pytest.raises(ValueError, match="fused_photometric"):
        aug.apply_exact_k(x, bx, m, d)

    def run(b, seed, fused):
        g = torch.Generator().manual_seed(seed)
        return aug.augment_batch_fast(g, *(t[:b] for t in (x, bx, m)), rotate=True,
                                      positional_crop=True, fused_photometric=fused)

    a, a2, c = run(16, 0, True), run(16, 0, True), run(16, 1, True)
    assert a[0].dtype == torch.float32 and all(torch.equal(u, v) for u, v in zip(a, a2))
    assert not torch.equal(a[0], c[0])
    assert a[0].min() >= 0 and a[0].max() <= 1
    assert all(torch.equal(u, v) for u, v in zip(run(8, 0, True), run(8, 0, False)))


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    imgs, seeds = inputs(rng, 8, 64, 48)
    sc = table(rng, 8, alpha=1.1, beta=-3.0, glass=rng.integers(0, 2, 8),
               motion=rng.integers(0, 2, 8))
    x, s, sd = (torch.from_numpy(a).cuda() for a in (imgs, sc, seeds))
    assert torch.equal(kp.photometric_batch(x, s, sd), kp.photometric_reference(x, s, sd))
    # halo-free and blurred images in one batch, all noised, at sides that
    # put rows and images off the 16-byte grid; then a view at an odd offset
    imgs, seeds = inputs(rng, 8, 37, 45)
    sc = table(rng, 8, sigma=9.0, glass=np.arange(8) % 2, motion=np.arange(8) // 4)
    x, s, sd = (torch.from_numpy(a).cuda() for a in (imgs, sc, seeds))
    got, want = kp.photometric_batch(x, s, sd), kp.photometric_reference(x, s, sd)
    assert (got - want).abs().max().item() <= ATOL
    flat = torch.cat([torch.zeros(1, device="cuda"), x.flatten()])[1:].view(x.shape)
    assert torch.equal(kp.photometric_batch(flat, s, sd), got)
