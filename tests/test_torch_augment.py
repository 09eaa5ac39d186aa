"""The port's device augmentation against fdtpu's, with fdtpu's draws
injected: the tests recompute every random choice from fdtpu's samplers and
keys (as ``tests/test_rotate.py`` recomputes the rotation gates), including
the ``rbg`` noise field, and hand them to the port's appliers. fdtpu's
rotation kernels run in interpret mode.

Tolerances:

* crop weights: equal (the same float32 steps); the float32 crop on the
  0-255 scale: atol 1e-3 (summation order); boxes and masks: equal.
* whole paths: images within 2/255 on the [0, 1] output, boxes and masks
  exactly equal. The images pass through bfloat16, where XLA and torch
  round at different places (XLA may keep excess precision through fused
  elementwise chains, torch rounds after each op): one bfloat16 step of
  the 0-255 image is 1/255 at the top of the range, so a difference of one
  step before the final /255 and one more in it stays within 2/255.
  Measured: the exact-k path equal, the per-sample path within 2e-7.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.data import augment as jaug
from fdtpu_torch.data import augment as aug

H = W = 64
IMG_ATOL = 2.0 / 255.0


def batch(b, seed=0, n=4):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(0, 50, (b, n, 2)).round()
    boxes[..., 3:5] = rng.uniform(2, 30, (b, n, 2)).round()
    masks = rng.uniform(size=(b, n)) > 0.3
    return imgs, boxes, masks


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def t_bf16(a):
    return t32(jnp.asarray(a).astype(jnp.float32)).to(torch.bfloat16)


def windows(wins):
    return tuple(t32([float(w[i]) for w in wins]) for i in range(4))


def run_both(key, imgs, boxes, masks, draws, apply, **kw):
    fdtpu = jax.jit(lambda k, i, b, m: jaug.augment_batch_fast(k, i, b, m, **kw))
    ji, jb, jm = fdtpu(key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(masks))
    gi, gb, gm = apply(torch.from_numpy(imgs), torch.from_numpy(boxes),
                       torch.from_numpy(masks), draws)
    return (gi, gb, gm), (np.asarray(ji.astype(jnp.float32)), np.asarray(jb), np.asarray(jm))


def assert_batches_match(got, want):
    gi, gb, gm = got
    wi, wb, wm = want
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(gm.numpy(), wm)
    np.testing.assert_array_equal(gb.numpy(), wb)
    np.testing.assert_allclose(gi.float().numpy(), wi, atol=IMG_ATOL, rtol=0)


# -- fdtpu's draws -------------------------------------------------------------------


def fdtpu_exact_k_draws(key, b, rotate, positional_crop):
    """Every draw of fdtpu's exact-k path (``augment.py:578-681``)."""
    kperm, kcrop, kpost = jax.random.split(key, 3)
    k = round(jaug.P_CROP * b)
    wins = [jaug._sample_crop(jax.random.split(ck, 5), H, W, gate=False)
            for ck in jax.random.split(kcrop, k)]
    rows = np.arange(k) if positional_crop else np.asarray(jax.random.permutation(kperm, b)[:k])
    rotate_rows = angles = None
    if rotate:
        krsel, kang = jax.random.split(jax.random.fold_in(key, 17))
        rk = round(jaug.P_ROTATE * b)
        rotate_rows = torch.from_numpy(np.array(jax.random.permutation(krsel, b)[:rk]))
        lim = jnp.deg2rad(jaug.ROTATE_LIMIT_DEG)
        angles = t32(jax.random.uniform(kang, (rk,), minval=-lim, maxval=lim))
    photo_start = (k if positional_crop and k + sum(jaug._photometric_counts(b)) <= b
                   else None)
    scalars, _, sels = jaug._sample_photometric_params_exact_k(kpost, b, start=photo_start)
    positional_flip = positional_crop and b % 2 == 0
    if positional_flip:
        scalars = scalars.at[:, 0].set((jnp.arange(b) % 2).astype(scalars.dtype))
    n = sels[0].shape[0]
    seed = jax.random.randint(jax.random.fold_in(kpost, 3), (), 0, 2**31 - 1)
    noise = jax.random.normal(jax.random.key(seed, impl="rbg"), (n, H, W, 3), dtype=jnp.bfloat16)
    return aug.ExactKDraws(
        crop_rows=torch.from_numpy(np.array(rows)), crop_window=windows(wins),
        scalars=t32(scalars), sels=tuple(torch.from_numpy(np.array(s)) for s in sels),
        noise=t_bf16(noise), photo_start=photo_start, positional_flip=positional_flip,
        rotate_rows=rotate_rows, angles=angles,
    )


def fdtpu_sample_draws(key, b, rotate):
    """Every draw of fdtpu's per-sample path (``augment_sample`` under
    ``vmap``, ``augment.py:217-234``, then ``:549-575``)."""
    cols = {n: [] for n in ("flip", "alpha", "beta", "noise_gate", "sigma", "glass",
                            "motion", "motion_angle")}
    wins, noise = [], []
    for ki in jax.random.split(jax.random.fold_in(key, 23), b):
        wins.append(jaug._sample_crop(jax.random.split(ki, 5), H, W))
        ks = jax.random.split(ki, 12)
        do_bc = jax.random.bernoulli(ks[6], jaug.P_BC)
        cols["flip"].append(jax.random.bernoulli(ks[5], jaug.P_FLIP))
        cols["alpha"].append(jnp.where(do_bc, 1.0 + jax.random.uniform(ks[7], minval=-0.2, maxval=0.2), 1.0))
        cols["beta"].append(jnp.where(do_bc, jax.random.uniform(ks[8], minval=-0.2, maxval=0.2) * 255.0, 0.0))
        cols["noise_gate"].append(jax.random.bernoulli(ks[9], jaug.P_NOISE))
        cols["sigma"].append(jnp.sqrt(jax.random.uniform(ks[10], minval=10.0, maxval=400.0)))
        noise.append(jax.random.normal(ks[11], (H, W, 3), dtype=jnp.bfloat16))
        kn = jax.random.split(jax.random.fold_in(ki, 7), 3)
        cols["glass"].append(jax.random.bernoulli(kn[0], jaug.P_GLASS))
        cols["motion"].append(jax.random.bernoulli(kn[1], jaug.P_MOTION))
        cols["motion_angle"].append(jax.random.uniform(kn[2], minval=0.0, maxval=jnp.pi))
    draws = aug.SampleDraws(crop_window=windows(wins), noise=t_bf16(jnp.stack(noise)),
                            **{n: t32(np.float32(v)) for n, v in cols.items()})
    if rotate:
        kg, ka = jax.random.split(jax.random.fold_in(key, 29))
        gate = jax.random.bernoulli(kg, jaug.P_ROTATE, (b,))
        lim = jnp.deg2rad(jaug.ROTATE_LIMIT_DEG)
        ang = jnp.where(gate, jax.random.uniform(ka, (b,), minval=-lim, maxval=lim), 0.0)
        draws.rotate_gate = torch.from_numpy(np.array(gate))
        draws.angles = t32(ang)
    return draws


# -- pieces --------------------------------------------------------------------------------


def test_crop_weight_mat_matches_fdtpu():
    rng = np.random.default_rng(3)
    offset = rng.uniform(0, 30, 5).astype(np.float32)
    span = rng.uniform(8, 64, 5).astype(np.float32)
    got = aug._crop_weight_mat(64, t32(offset), t32(span)).numpy()
    for i in range(5):
        want = np.asarray(jaug._crop_weight_mat(64, jnp.float32(offset[i]), jnp.float32(span[i])))
        np.testing.assert_array_equal(got[i], want)


def test_apply_crop_matches_fdtpu():
    imgs, boxes, masks = batch(4, seed=1)
    wins = [jaug._sample_crop(jax.random.split(k, 5), H, W, gate=False)
            for k in jax.random.split(jax.random.PRNGKey(4), 4)]
    gi, gb, gm = aug._apply_crop(torch.from_numpy(imgs).float(), torch.from_numpy(boxes),
                                 torch.from_numpy(masks), *windows(wins))
    for i, win in enumerate(wins):
        wi, wb, wm = jaug._apply_crop(jnp.asarray(imgs[i], jnp.float32), jnp.asarray(boxes[i]),
                                      jnp.asarray(masks[i]), *win)
        np.testing.assert_allclose(gi[i].numpy(), np.asarray(wi), atol=1e-3, rtol=0)
        np.testing.assert_array_equal(gb[i].numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gm[i].numpy(), np.asarray(wm))


def test_filters_match_fdtpu():
    np.testing.assert_allclose(aug._gaussian_kernel5().numpy(),
                               np.asarray(jaug._gaussian_kernel5()), atol=1e-7, rtol=0)
    ang = np.float32([0.1, 1.3, 2.9])
    want = np.stack([np.asarray(jaug._motion_kernel7(jnp.float32(a))) for a in ang])
    np.testing.assert_allclose(aug._motion_kernel7(t32(ang)).numpy(), want, atol=1e-6, rtol=0)


# -- whole paths -----------------------------------------------------------------------------


@pytest.mark.parametrize("positional_crop", [True, False])
def test_exact_k_path_matches_fdtpu(positional_crop):
    """b = 16: exact-k crop, rotation and photometric, with fdtpu's draws."""
    key = jax.random.PRNGKey(7 + positional_crop)
    imgs, boxes, masks = batch(16, seed=2)
    draws = fdtpu_exact_k_draws(key, 16, rotate=True, positional_crop=positional_crop)
    got, want = run_both(key, imgs, boxes, masks, draws, aug.apply_exact_k,
                         rotate=True, positional_crop=positional_crop)
    assert got[0].dtype == torch.bfloat16
    assert_batches_match(got, want)


@pytest.mark.parametrize("rotate", [True, False])
def test_per_sample_path_matches_fdtpu(rotate):
    """b = 8: per-sample gates, then gated rotation of the whole batch."""
    key = jax.random.PRNGKey(11)
    imgs, boxes, masks = batch(8, seed=3)
    draws = fdtpu_sample_draws(key, 8, rotate)
    if rotate:
        assert draws.rotate_gate.any()
    got, want = run_both(key, imgs, boxes, masks, draws, aug.apply_per_sample, rotate=rotate)
    assert got[0].dtype == torch.float32
    assert_batches_match(got, want)


@pytest.mark.parametrize("b,positional", [(16, True), (128, True), (128, False), (20, False)])
def test_exact_k_counts(b, positional):
    gen = torch.Generator().manual_seed(b)
    d = aug.sample_exact_k(gen, b, 32, 32, "cpu", rotate=True, positional_crop=positional)
    k = round(0.2 * b)
    assert d.crop_rows.shape == (k,) and d.rotate_rows.shape == d.angles.shape == (k,)
    assert [s.shape[0] for s in d.sels] == [k, k, k]
    rows = torch.cat(d.sels)
    assert len(set(rows.tolist())) == 3 * k  # disjoint
    assert (d.scalars[:, 3] > 0).sum() == (d.scalars[:, 4] == 1).sum() == (d.scalars[:, 5] == 1).sum() == k
    assert d.noise.shape == (k, 32, 32, 3) and d.noise.dtype == torch.bfloat16
    assert d.angles.abs().max() <= math.radians(20.0)
    if positional:
        assert d.photo_start == k
        assert rows.tolist() == list(range(k, 4 * k))
        assert d.crop_rows.tolist() == list(range(k))
    else:
        assert d.photo_start is None and len(set(d.crop_rows.tolist())) == k


def test_positional_flip_flips_odd_rows():
    """fdtpu's ``positional_flip`` (ROADMAP F4, ``augment.py:661-665``):
    under ``positional_crop`` at even B the odd rows flip, the even rows
    never do, boxes follow."""
    imgs, boxes, masks = batch(16, seed=4)
    d = aug.sample_exact_k(torch.Generator().manual_seed(0), 16, H, W, "cpu",
                           rotate=False, positional_crop=True)
    assert d.positional_flip and d.scalars[:, 0].tolist() == [i % 2 for i in range(16)]
    d.scalars[:, 1], d.scalars[:, 2] = 1.0, 0.0  # no brightness/contrast
    out, ob, _ = aug.apply_exact_k(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                   torch.from_numpy(masks), d)
    x = torch.from_numpy(imgs).to(torch.bfloat16)
    for r in range(12, 16):  # rows outside the crop and photometric blocks
        want = (x[r].flip(1) if r % 2 else x[r]) / 255.0
        assert torch.equal(out[r], want), r
        wx = W - boxes[r, :, 1] - boxes[r, :, 3] if r % 2 else boxes[r, :, 1]
        np.testing.assert_array_equal(ob[r, :, 1].numpy(), np.round(wx))


@pytest.mark.parametrize("b", [8, 16])
def test_one_seed_one_batch(b):
    imgs, boxes, masks = (torch.from_numpy(a) for a in batch(b, seed=5))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return aug.augment_batch_fast(gen, imgs, boxes, masks, rotate=True, positional_crop=True)

    a, b2, c = run(0), run(0), run(1)
    for x, y in zip(a, b2):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert a[0].min() >= 0 and a[0].max() <= 1 and torch.isfinite(a[0].float()).all()


def test_resize_only_batch_matches_fdtpu():
    imgs, boxes, masks = batch(3, seed=6)
    boxes[0, 0, 3:5] = [2.0, 4.0]  # area 8 < 10
    gi, gb, gm = aug.resize_only_batch(*(torch.from_numpy(a) for a in (imgs, boxes, masks)))
    wi, wb, wm = jaug.resize_only_batch(jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(masks))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert not gm[0, 0]


# -- audits of the port's own draws (no fdtpu involved) ------------------------------------


class _IdSource:
    """A data source whose sample ``i`` is an image filled with ``i``, so a
    batch names the samples it holds; one box each."""

    def __init__(self, n, side):
        self.n, self.side = n, side

    def __len__(self):
        return self.n

    def get(self, i):
        from fdtpu_torch.core.boxes import pad_boxes

        boxes, mask = pad_boxes(np.float32([[1, 2, 2, 8, 8]]), 2)
        return np.full((self.side, self.side, 3), i, np.uint8), boxes, mask


def marginal_counts(epochs, b, shuffle, n=64, side=32, positional=None):
    """Per-sample crop, flip and noise counts over ``epochs`` epochs of a
    real ``BatchLoader`` feed, each step's draws made as the train step
    makes them (its generator reseeded from the seed and the step, positional
    subsets as the Trainer resolves them for the feed unless ``positional``
    says otherwise)."""
    positional = shuffle if positional is None else positional
    from fdtpu_torch.data import BatchLoader
    from fdtpu_torch.train.step import step_seed

    loader = BatchLoader(_IdSource(n, side), b, shuffle=shuffle, seed=0, drop_last=True)
    counts = {k: np.zeros(n) for k in ("crop", "flip", "noise")}
    step = 0
    for _ in range(epochs):
        for batch in loader:
            ids = batch.images[:, 0, 0, 0].astype(np.int64)
            gen = torch.Generator().manual_seed(step_seed(0, step))
            step += 1
            if b < 16:
                d = aug.sample_per_sample(gen, b, side, side, "cpu", rotate=False)
                cw, ch = d.crop_window[2].numpy(), d.crop_window[3].numpy()
                crop = (cw != side) | (ch != side)
                flip, noise = d.flip.numpy() > 0.5, d.noise_gate.numpy() > 0.5
            else:
                d = aug.sample_exact_k(gen, b, side, side, "cpu", rotate=False,
                                       positional_crop=positional)
                crop = np.isin(np.arange(b), d.crop_rows.numpy())
                flip = d.scalars[:, 0].numpy() > 0.5
                noise = np.isin(np.arange(b), d.sels[0].numpy())
            for key, hit in (("crop", crop), ("flip", flip), ("noise", noise)):
                np.add.at(counts[key], ids[hit], 1)
    return counts


def dispersion_p_value(counts, epochs, p):
    """Upper-tail p-value of the index of dispersion of per-sample counts
    against Binomial(epochs, p): large when a sample's chance of the op
    depends on which sample it is."""
    from scipy.stats import chi2

    d = ((counts - epochs * p) ** 2).sum() / (epochs * p * (1 - p))
    return chi2.sf(d, len(counts) - 1)


@pytest.mark.parametrize("b", [8, 16])
def test_augmentation_marginals_are_binomial(b):
    """Over 120 epochs of a shuffled feed, each sample is cropped, flipped
    and noised as often as Binomial(120, p) says: on the per-sample path
    (B = 8, independent gates, p = 0.2 / 0.5 / 0.2) and on the exact-k path
    with positional subsets (B = 16: the first 3 rows cropped, odd rows
    flipped, the next 3 noised; p = 3/16 / 1/2 / 3/16), whose argument rests
    on the shuffle. Every p-value above 1e-3, every mean within 4 standard
    errors."""
    epochs, n = 120, 64
    counts = marginal_counts(epochs, b, shuffle=True, n=n)
    ps = {"crop": 0.2, "flip": 0.5, "noise": 0.2} if b < 16 else \
        {"crop": 3 / 16, "flip": 0.5, "noise": 3 / 16}
    for key, p in ps.items():
        c = counts[key]
        se = math.sqrt(epochs * p * (1 - p) / n)
        assert abs(c.mean() - epochs * p) < 4 * se, (key, c.mean())
        assert dispersion_p_value(c, epochs, p) > 1e-3, key


def test_marginal_audit_catches_an_unshuffled_feed():
    """The audit's power: positional subsets forced on a feed without the
    shuffle (which the Trainer never does) crop and flip the same samples
    every epoch, and the dispersion says so."""
    counts = marginal_counts(30, 16, shuffle=False, positional=True)
    assert dispersion_p_value(counts["crop"], 30, 3 / 16) < 1e-12
    assert dispersion_p_value(counts["flip"], 30, 0.5) < 1e-12


def assert_standard_normal(x: np.ndarray, what: str):
    """Mean, variance, tails and the Kolmogorov-Smirnov distance of a field
    against N(0, 1), at bars about 5 standard errors of its size."""
    from scipy.stats import kstest

    x = x.astype(np.float64).ravel()
    n = x.size
    assert abs(x.mean()) < 5 / math.sqrt(n), what
    assert abs(x.var() - 1.0) < 5 * math.sqrt(2 / n), what
    for k, inside in ((1, 0.682689), (2, 0.954500), (3, 0.997300)):
        frac = (np.abs(x) < k).mean()
        assert abs(frac - inside) < 5 * math.sqrt(inside * (1 - inside) / n) + 2e-3, (what, k)
    assert kstest(x, "norm").statistic < 0.006, what


def test_noise_fields_are_standard_normal():
    """The port's noise, by its distribution (its bits cannot be JAX's): the
    default route's bfloat16 field (bfloat16 rounding moves the KS distance
    by about 2^-9), and the fused route's murmur3 Box-Muller field, whose
    planes must also be uncorrelated with each other and change with the
    seed."""
    from fdtpu_torch.kernels.photometric import noise_field

    gen = torch.Generator().manual_seed(11)
    d = aug.sample_exact_k(gen, 64, 96, 96, "cpu", rotate=False, positional_crop=True)
    assert_standard_normal(d.noise.float().numpy(), "default route")

    seeds = torch.randint(0, 2**31 - 1, (12,), generator=gen, dtype=torch.int32)
    field = noise_field(seeds, 96, 96).numpy()
    assert_standard_normal(field, "fused route")
    planes = field.reshape(12, -1)
    corr = np.corrcoef(planes)[np.triu_indices(12, 1)]
    assert np.abs(corr).max() < 5 / math.sqrt(planes.shape[1])
    assert not np.array_equal(noise_field(seeds + 1, 96, 96).numpy(), field)
