"""The port's SSD against fdtpu's, at 64 px (patch sizes (8, 4, 2, 1), 85
priors) with 4 filters, from the same params (fdtpu's, converted by
``ssd_state_dict``) and the same numpy inputs; fdtpu's Pallas K1 in
interpret mode. Every fdtpu model here has one shape, so that JAX compiles
its ops once for the whole file.

fdtpu's prior and target functions are called eagerly: under ``jit`` XLA
turns a division by a constant into a product with its float32 reciprocal,
so fdtpu's jitted forward and train step place some priors one float32
step from the eager values (and from the port's, which divide).

Gates (measured values in brackets):

* priors, scales, ``encode_ssd_targets``, ``apply_priors``, ``decode_ssd``,
  ``ssd_decode_tables`` and the mining masks: bit-equal;
* ``ssd_loss`` (``bg_push`` 0 and 0.02, and no positives) and
  ``ssd_loss2``: rtol 1e-6, the sums' order apart;
* the float32 forward: atol 1e-5 [~1.5e-7]: summation order only. The
  bfloat16 forward: atol 2^-5 on the boxes and 2^-7 on the scores, see
  ``test_forward_bf16_matches_fdtpu``;
* decode + filter + NMS of one model output (``Detector.non_max_suppression``,
  ``predict``, ``ssd_decode_filter_nms``): bit-equal to K1;
* one float32 SAM + Adam step (augmentation and dropout off) from fdtpu's
  state, advanced twice: loss and grad norm rtol 1e-5, params rtol 1e-4;
  the eval step's scalars rtol 1e-5;
* the Trainer, one quarter-epoch (Adam) and one eval on the same images
  (N = 85 <= capacity 128, where fdtpu's XLA decode does not truncate):
  epoch metrics rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.core import priors as jpriors
from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.kernels import pallas_decode_filter_nms_batch
from fdtpu.kernels import ssd_decode_tables as jax_ssd_decode_tables
from fdtpu.kernels import ssd_output_decode_tables as jax_ssd_output_tables
from fdtpu.losses import ssd as jloss
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import ssd_patch_sizes as jax_ssd_patch_sizes
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.train import loop as jax_loop
from fdtpu.train.state import TrainState as JaxTrainState
from fdtpu.train.state import make_optimizer as jax_make_optimizer
from fdtpu.train.step import make_eval_step as jax_make_eval_step
from fdtpu.train.step import make_train_step as jax_make_train_step
from fdtpu.utils.config import SSDConfig as JaxSSDConfig
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import poolresnet_state_dict, ssd_state_dict, train_state_from_fdtpu
from fdtpu_torch.core import priors as tpriors
from fdtpu_torch.core.nms import ssd_decode_filter_nms
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.losses import ssd as tloss
from fdtpu_torch.models import SSD, Detector, ssd_patch_sizes
from fdtpu_torch.train import Trainer, make_eval_step, make_train_step
from fdtpu_torch.utils.config import SSDConfig, TrainConfig

SIZE = (64, 64)
PS = (8, 4, 2, 1)
N = 85
F = 4
SPE = 10
NMS = (0.05, 0.5, 128)  # a low threshold, so the fresh model's boxes reach the metrics


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def jax_model(dtype=jnp.float32):
    return JaxSSD(filters=F, input_shape=SIZE, patch_sizes=PS, dropout=0.0, dtype=dtype)


def torch_model():
    return SSD(F, SIZE, PS, dropout=0.0)


@pytest.fixture(scope="module")
def params():
    """fdtpu's SSD param tree (names and shapes from ``jax.eval_shape`` of
    its init), filled with torch's default init drawn by numpy: every kernel
    and bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, as fdtpu's
    ``torch_init`` draws them. (fdtpu's own init compiles for ~20 s here.)"""
    shapes = jax.eval_shape(jax_model().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *SIZE, 3)))["params"]
    rng = np.random.default_rng(0)

    def layer(tree):
        bound = 1 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
        return {k: jnp.asarray(rng.uniform(-bound, bound, v.shape).astype(np.float32))
                for k, v in sorted(tree.items())}

    return {name: (layer(tree) if "kernel" in tree
                   else {c: layer(conv) for c, conv in sorted(tree.items())})
            for name, tree in sorted(shapes.items())}


def jax_state(jcfg, params, steps_per_epoch=SPE):
    """fdtpu's train state around a copy of ``params`` (its step donates
    the state)."""
    own = jax.tree.map(jnp.copy, params)
    tx = jax_make_optimizer(jcfg, steps_per_epoch)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=own, batch_stats={},
                         opt_state=tx.init(own)), tx


def converted(params):
    m = torch_model()
    m.load_state_dict(ssd_state_dict(jax.tree.map(np.asarray, params)))
    return m


def frames(b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, *SIZE, 3), dtype=np.uint8)


def data(b=4, k=6, seed=0):
    """u8 frames and padded pixel boxes, some over the image's edges, two in
    one cell of every scale; the last sample is padding."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, k, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(-6, 62, (b, k, 2)).round()
    boxes[..., 3:5] = rng.uniform(4, 30, (b, k, 2)).round()
    boxes[:, 1, 1:3] = boxes[:, 0, 1:3] + 1  # the same cell as box 0 at every scale
    masks = rng.uniform(size=(b, k)) > 0.25
    masks[:, :2] = True
    sample_mask = np.ones((b,), bool)
    sample_mask[-1] = False
    return frames(b, seed), boxes, masks, sample_mask


# -- config, priors, targets, tables -------------------------------------------------


def test_ssd_config_duplicates_fdtpu():
    assert SSDConfig() == SSDConfig(**vars(JaxSSDConfig()))
    assert SSDConfig().image_size == JaxSSDConfig().image_size
    for size in (64, 128, 480, 640, 632):
        assert ssd_patch_sizes((size, size)) == jax_ssd_patch_sizes((size, size))


@pytest.mark.parametrize("patch_sizes", [(60, 30, 15, 7), PS, (80, 40, 20, 10), (16, 8, 4, 2)])
def test_priors_scales_and_tables_bit_equal(patch_sizes):
    np.testing.assert_array_equal(tpriors.calculate_priors(patch_sizes).numpy(),
                                  np.asarray(jpriors.calculate_priors(patch_sizes)))
    np.testing.assert_array_equal(tpriors.prior_scales(patch_sizes).numpy(),
                                  np.asarray(jpriors.prior_scales(patch_sizes)))
    assert tpriors.num_priors(patch_sizes) == jpriors.num_priors(patch_sizes)
    for image_size in ((8 * patch_sizes[0],) * 2, (500, 377)):
        got = knms.ssd_decode_tables(patch_sizes, image_size)
        want = jax_ssd_decode_tables(patch_sizes, image_size)
        for g, w in zip(got, want):
            assert type(g) is type(w)
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
    assert tpriors.num_priors() == 4774


@pytest.mark.parametrize("image_size", [SIZE, (480, 480), (101, 77)])
def test_encode_ssd_targets_bit_equal(image_size):
    _, boxes, masks, _ = data(b=5, k=9, seed=1)
    boxes[..., 1:] *= image_size[0] / 64
    ps = ssd_patch_sizes(image_size[::-1])
    got = tpriors.encode_ssd_targets(*as_torch(boxes, masks), ps, image_size).numpy()
    want = np.asarray(jax.vmap(lambda b, m: jpriors.encode_ssd_targets(b, m, ps, image_size))(
        jnp.asarray(boxes), jnp.asarray(masks)))
    assert got.shape == (5, tpriors.num_priors(ps), 5)
    np.testing.assert_array_equal(got, want)
    # two boxes in one cell at every scale: the later one wins
    two = torch.tensor([[[1.0, 3, 3, 10, 12], [1.0, 4, 4, 20, 22]]])
    enc = tpriors.encode_ssd_targets(two, torch.ones(1, 2, dtype=torch.bool), ps, image_size)
    starts = np.cumsum([0, *(p * p for p in ps[:-1])])
    w, h = image_size
    for start in starts:
        np.testing.assert_array_equal(enc[0, start, 3:].numpy(), np.float32([20 / w, 22 / h]))
    assert (enc[0, :, 0] > 0).sum() == len(ps)


def test_apply_priors_and_decode_ssd_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, N, 5)).astype(np.float32)
    pr, sc = tpriors.calculate_priors(PS), tpriors.prior_scales(PS)
    np.testing.assert_array_equal(
        tpriors.apply_priors(torch.from_numpy(x), pr, sc).numpy(),
        np.asarray(jpriors.apply_priors(jnp.asarray(x), jnp.asarray(pr.numpy()),
                                        jnp.asarray(sc.numpy()))))
    for image_size in (SIZE, (90, 70)):
        np.testing.assert_array_equal(
            tpriors.decode_ssd(torch.from_numpy(x), PS, image_size).numpy(),
            np.asarray(jpriors.decode_ssd(jnp.asarray(x), PS, image_size)))


# -- mining and losses ---------------------------------------------------------------


def loss_inputs(seed, b=3, n=N, pos=5):
    """Post-sigmoid confidences rounded to bfloat16 (many exact ties),
    docked labels with ``pos`` positives an image, and locations."""
    rng = np.random.default_rng(seed)
    conf = rng.choice(np.float32([0.25, 0.5, 0.625, 0.75, 1.0, 1e-9]), size=(b, n))
    conf = np.where(rng.uniform(size=(b, n)) < 0.5, conf,
                    torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32))
                    .bfloat16().float().numpy())
    labels = np.zeros((b, n), np.float32)
    for i in range(b):
        labels[i, rng.choice(n, size=pos, replace=False)] = 1.0 - 0.001 * rng.choice(PS, size=pos)
    pred = rng.normal(0.5, 0.6, (b, n, 4)).astype(np.float32)
    gt = rng.normal(0.5, 0.6, (b, n, 4)).astype(np.float32)
    return conf.astype(np.float32), pred, labels, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_hard_negative_mining_masks_equal_with_ties(seed):
    conf, _, labels, _ = loss_inputs(seed)
    labels[1] = 0.0  # an image without positives mines nothing
    loss = -np.log(np.clip(conf, 1e-7, 1.0))
    for ratio in (3, 10):
        got = tloss.hard_negative_mining(*as_torch(loss, labels), ratio).numpy()
        want = np.asarray(jloss.hard_negative_mining(jnp.asarray(loss), jnp.asarray(labels), ratio))
        np.testing.assert_array_equal(got, want)
        assert not got[1].any()
        assert (got.sum(1)[[0, 2]] == 5 + 5 * ratio).all()  # the positives and 5 x ratio


@pytest.mark.parametrize("bg_push,no_positives", [(0.0, False), (0.02, False), (0.0, True)])
def test_ssd_loss_matches_fdtpu(bg_push, no_positives):
    conf, pred, labels, gt = loss_inputs(3)
    if no_positives:
        labels[:] = 0.0
    got = tloss.ssd_loss(*as_torch(conf, pred, labels, gt), 10, bg_push).item()
    want = float(jloss.ssd_loss(*(jnp.asarray(a) for a in (conf, pred, labels, gt)), 10, bg_push))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ssd_loss2_and_smooth_l1_match_fdtpu():
    conf, pred, labels, _ = loss_inputs(4)
    p = np.concatenate([conf[..., None], pred], -1)
    g = np.concatenate([labels[..., None], np.abs(pred[..., ::-1])], -1)
    np.testing.assert_allclose(tloss.ssd_loss2(*as_torch(p, g)).item(),
                               float(jloss.ssd_loss2(jnp.asarray(p), jnp.asarray(g))), rtol=1e-6)
    d = np.linspace(-3, 3, 97, dtype=np.float32)
    np.testing.assert_array_equal(tloss.smooth_l1(torch.from_numpy(d)).numpy(),
                                  np.asarray(jloss.smooth_l1(jnp.asarray(d))))


# -- the model -------------------------------------------------------------------------


def test_forward_f32_matches_fdtpu(params):
    x = frames(seed=3).astype(np.float32) / 255.0
    want = np.asarray(jax_model().apply({"params": params}, jnp.asarray(x)))
    got = converted(params).eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, N, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_forward_bf16_matches_fdtpu(params):
    """Both compute in bfloat16 with float32 params, but XLA and torch round
    at different places (F3, F5: a single activation may differ by a
    bfloat16 step, 2^-8 relative), and 15 convolutions carry it on. The
    scores go through a sigmoid (slope <= 1/4): atol 2^-7 as PoolResnet's.
    The boxes are linear in the heads' raw outputs, of order 1: atol 2^-5,
    four bfloat16 steps of a unit value."""
    x = frames(seed=4).astype(np.float32) / 255.0
    want = np.asarray(jax_model(jnp.bfloat16).apply({"params": params}, jnp.asarray(x)))
    det = Detector(converted(params), dtype=torch.bfloat16)
    got = det.apply(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and det.net.stem.weight.dtype == torch.bfloat16
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2.0 ** -7, rtol=0)
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=2.0 ** -5, rtol=0)


def test_ssd_state_dict_names_and_raises(params):
    p = jax.tree.map(np.asarray, params)
    sd = ssd_state_dict(p)
    assert set(sd) == set(torch_model().state_dict())
    # a block that widens holds its 1x1 skip as Conv_0 and its 3x3 convs as Conv_1/2
    np.testing.assert_array_equal(
        sd["extractor.0.skip.weight"].numpy(),
        p["SSDResidualBlock_0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["extractor.0.conv1.weight"].shape == (2 * F, F, 3, 3)
    assert sd["extractor.1.conv1.weight"].shape == (2 * F, 2 * F, 3, 3)  # no skip: Conv_0
    np.testing.assert_array_equal(sd["heads.3.weight"].numpy(), p["Dense_3"]["kernel"].T)
    with pytest.raises(ValueError):
        ssd_state_dict({k: v for k, v in p.items() if k != "Dense_3"})
    with pytest.raises(ValueError):
        ssd_state_dict({"Conv_0": p["Conv_0"], "Conv_1": p["Conv_0"], "ResidualBlock_0": {}})
    with pytest.raises(ValueError):
        poolresnet_state_dict(p)
    # SSD-16 at 480 px: skips in extractor blocks 0 and 8 and scale blocks 0 and 1
    full = SSD(16, (480, 480))
    assert [i for i, blk in enumerate(full.extractor) if blk.skip is not None] == [0, 8]
    assert [i for i, blk in enumerate(full.scales) if blk.skip is not None] == [0, 1]


# -- decode + filter + NMS ---------------------------------------------------------------


def k1(values, tables, prob, iou, cap):
    boxes, mask = pallas_decode_filter_nms_batch(jnp.asarray(values), tables, prob, iou, cap,
                                                 interpret=True)
    return np.asarray(boxes), np.asarray(mask)


def assert_same(got, want):
    (gb, gm), (wb, wm) = (tuple(np.asarray(a) for a in pair) for pair in (got, want))
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gb, wb)


def test_decode_matches_k1(params):
    """``non_max_suppression`` and ``predict`` on the model's output, and
    raw encoded rows through ``ssd_decode_filter_nms``: K1 at B = 3 with
    one set of thresholds each (one interpret-mode compile)."""
    x = frames(b=3, seed=5).astype(np.float32) / 255.0
    out = np.array(jax_model().apply({"params": params}, jnp.asarray(x)))
    tables = jax_ssd_output_tables(N, SIZE)
    det = Detector(converted(params), 0.5, 0.5, 128, dtype=torch.float32)
    got = det.non_max_suppression(torch.from_numpy(out))
    want = k1(out, tables, 0.5, 0.5, 128)
    assert_same(got, want)
    assert want[1].sum(1).min() > 0
    # predict: a frame through the port's forward, then K1 (image 0 of 3)
    norm, boxes, mask = det.predict(frames(b=1, seed=6)[0])
    out[0] = det.apply(norm[None]).numpy()[0]
    want = k1(out, tables, 0.5, 0.5, 128)
    assert_same((boxes, mask), (want[0][0], want[1][0]))
    # raw encoded rows: the priors folded into the tables
    raw = np.random.default_rng(7).uniform(0, 1, (3, N, 5)).astype(np.float32)
    got = ssd_decode_filter_nms(torch.from_numpy(raw), PS, SIZE, 0.5, 0.5, 128)
    assert_same(got, k1(raw, jax_ssd_decode_tables(PS, SIZE), 0.5, 0.5, 128))
    one = ssd_decode_filter_nms(torch.from_numpy(raw[1]), PS, SIZE, 0.5, 0.5, 128)
    assert_same(one, (got[0][1], got[1][1]))


# -- the train and eval steps ----------------------------------------------------------------


def test_train_step_matches_fdtpu(params):
    """One float32 SAM + Adam step from fdtpu's state after two fdtpu steps
    (Adam's moments then carry across, and its first, sign-like step does
    not amplify rounding noise)."""
    jcfg = JaxTrainConfig(learning_rate=1e-3)
    jm = jax_model()
    jstate, tx = jax_state(jcfg, params)
    jstep = jax_make_train_step(jm, tx, jcfg, augment=False)

    def jax_step(state, batch):
        return jstep(state, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))

    for seed in (0, 1):
        jstate, _ = jax_step(jstate, data(seed=seed))
    tcfg = TrainConfig(learning_rate=1e-3)
    ts = train_state_from_fdtpu(jstate, torch_model(), tcfg, SPE)
    assert ts.step == 2
    batch = data(seed=2)
    jnew, jsc = jax_step(jstate, batch)
    ts, sc = make_train_step(ts.module, tcfg, augment=False)(ts, *as_torch(*batch))
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(sc["grad_norm"].item(), float(jsc["grad_norm"]), rtol=1e-5)
    want = ssd_state_dict(jax.tree.map(np.asarray, jnew.params))
    for name, p in ts.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)

    # the eval step: loss and metrics at N <= capacity
    imgs, boxes, masks, sm = data(seed=3)
    want = jax_make_eval_step(jm, jcfg, nms_params=NMS)(
        jnew, *(jnp.asarray(a) for a in (imgs, boxes, masks, sm)))
    got = make_eval_step(ts.module, nms_params=NMS)(ts, *as_torch(imgs, boxes, masks, sm))
    for k in ("loss", "iou", "recall", "precision"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(want["iou"]) > 0


# -- the Trainer -----------------------------------------------------------------------------


def make_dataset(root, make):
    make(root, 32, split="train", seed=0, max_faces=4)
    make(root, 6, split="val", seed=1, max_faces=4)
    return root


def loaders(root, source_cls, loader_cls, parse, **extra):
    train = source_cls(parse(root, "train", 120), SIZE, box_capacity=128, error_log=None, **extra)
    val = source_cls(parse(root, "val", 120), SIZE, box_capacity=128, error_log=None, **extra)
    return (loader_cls(train, 4, shuffle=True, seed=2, drop_last=True, epoch_fraction=4),
            loader_cls(val, 4))


def test_trainer_matches_fdtpu(params, tmp_path, monkeypatch):
    """fdtpu's Trainer and the port's, each over its own byte-identical
    copy of the data, one quarter-epoch of Adam (SAM off: the step test
    above holds SAM) and one eval, from the same params (fdtpu's Trainer is
    handed them in place of its init)."""
    monkeypatch.setattr(jax_loop, "create_train_state",
                        lambda module, config, rng, steps_per_epoch: jax_state(
                            config, params, steps_per_epoch))
    kw = dict(learning_rate=1e-3, use_sam=False, max_epochs=1, batch_size=4, box_capacity=128,
              visualize_first_batch=False, log_every_steps=0)
    jtrain, jval = loaders(make_dataset(tmp_path / "fdtpu_data", jax_make_synthetic), JaxSource,
                           JaxBatchLoader, jax_load_targets, use_native=False)
    jt = JaxTrainer(jax_model(), JaxTrainConfig(**kw, checkpoint_dir=str(tmp_path / "jc"),
                                                log_path=str(tmp_path / "jl" / "out.log")),
                    jtrain, jval, augment=False, nms_params=NMS, run_name="fdtpu")
    train, val = loaders(make_dataset(tmp_path / "port_data", make_synthetic_widerface),
                         WIDERFaceDataSource, BatchLoader, load_targets, use_native=False)
    assert len(train) == len(jtrain) == 2  # a quarter of 32 images, batch 4
    tt = Trainer(converted(params), TrainConfig(**kw, checkpoint_dir=str(tmp_path / "tc"),
                                                log_path=str(tmp_path / "tl" / "out.log")),
                 train, val, augment=False, nms_params=NMS, run_name="port", device="cpu")
    want, got = jt.fit(), tt.fit()
    assert tt.state.step == int(jt.state.step) == 2
    for split in ("train", "val"):
        assert list(got[split]) == list(want[split])
        assert set(want[split]) == {"loss", "iou", "recall", "precision", "f1"}
        for k in want[split]:
            np.testing.assert_allclose(got[split][k], want[split][k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{split} {k}")
    assert want["val"]["iou"] > 0
