"""The port's train and eval steps against fdtpu's, from the same converted
params, at 160 px with 16 filters and 2 blocks.

Unless a test says otherwise: float32, augmentation off, dropout off (rates
0 on both sides), the same numpy batch. Tolerances (measured values in brackets):

* ``sam_gradients``: rtol 1e-4 (atol 1e-6 for gradients near 0): the two
  forwards differ by summation order only (~2e-7, test_torch_models.py),
  and the perturbation direction carries it into the second point;
* one SGD step: params atol 1e-6, an update of lr * g with lr = 1e-2
  [1.5e-8];
* one Adam step from a state fdtpu advanced twice: params atol 1e-6 with
  lr = 1e-3 [1.5e-8]. Adam's early steps move each param by about lr
  times a ratio of moments; the moments come across exactly, and a
  gradient near 0 can turn that ratio on its rounding, which the bar
  allows for at 1e-3 of the step;
* the bfloat16 step: loss rtol 2e-3 [7e-5], grad norm rtol 1e-2 [1.7e-4].
  Both forwards compute in bfloat16 with float32 params, but XLA and
  torch round at different places, so single activations may differ by a
  bfloat16 step (2^-8 relative);
* ``make_lr_schedule``: equal to optax's float32 values;
* eval scalars on a shared forward output: loss rtol 1e-6, metrics equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.train import metrics as jmetrics
from fdtpu.train.sam import sam_gradients as jax_sam_gradients
from fdtpu.train.state import create_train_state as jax_create_train_state
from fdtpu.train.state import make_lr_schedule as jax_make_lr_schedule
from fdtpu.train.step import _encode_targets as jax_encode_targets
from fdtpu.train.step import _loss_and_out as jax_loss_and_out
from fdtpu.train.step import make_eval_step as jax_make_eval_step
from fdtpu.train.step import make_train_step as jax_make_train_step
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import poolresnet_state_dict, train_state_from_fdtpu
from fdtpu_torch.models import PoolResnet
from fdtpu_torch.models.layers import DropoutMasks
from fdtpu_torch.train import (
    average_precision,
    create_train_state,
    detection_metrics,
    make_eval_step,
    make_lr_schedule,
    make_train_step,
    sam_gradients,
)
from fdtpu_torch.train import step as tstep
from fdtpu_torch.utils.config import TrainConfig

SIZE = (160, 160)
S = 5
SPE = 10


def jax_model(dtype=jnp.float32, dropout=0.0):
    return JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                         dropout=dropout, head_dropout=dropout, dtype=dtype)


def torch_model(compute_dtype=None, dropout=0.0):
    return PoolResnet(16, SIZE, S, 2, dropout=dropout, head_dropout=dropout,
                      compute_dtype=compute_dtype)


def data(b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, *SIZE, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(0, 110, (b, 4, 2)).round()
    boxes[..., 3:5] = rng.uniform(20, 90, (b, 4, 2)).round()
    masks = rng.uniform(size=(b, 4)) > 0.3
    sample_mask = np.ones((b,), bool)
    sample_mask[-1] = False
    return imgs, boxes, masks, sample_mask


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def pair(config_kw, dtype=jnp.float32, compute_dtype=None, seed=1):
    jcfg = JaxTrainConfig(**config_kw)
    jm = jax_model(dtype)
    jstate, tx = jax_create_train_state(jm, jcfg, jax.random.PRNGKey(seed), SPE)
    tcfg = TrainConfig(**config_kw)
    tstate = train_state_from_fdtpu(jstate, torch_model(compute_dtype), tcfg, SPE)
    return jm, jstate, tx, jcfg, tstate, tcfg


def jax_step(jm, tx, jcfg, jstate, batch, **kw):
    step = jax_make_train_step(jm, tx, jcfg, augment=False, **kw)
    return step(jstate, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))


def assert_params_close(module, jparams, atol):
    want = poolresnet_state_dict(jax.tree.map(np.asarray, jparams))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_sam_gradients_match_fdtpu():
    jm = jax_model()
    variables = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, *SIZE, 3)))
    tm = torch_model()
    tm.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"])))
    imgs, boxes, masks, sm = data()
    x = imgs.astype(np.float32) / 255.0
    enc, _ = jax_encode_targets(jm, jnp.asarray(boxes), jnp.asarray(masks), (160, 160))
    jfn = lambda p: jax_loss_and_out(jm, p, {}, jnp.asarray(x), enc, None, None, False, 10,
                                     jnp.asarray(sm))
    jloss, (jsum, _, _), jgrads = jax.jit(lambda p: jax_sam_gradients(jfn, p, 0.05))(
        variables["params"])

    params = list(tm.parameters())
    xt, enc_t, smt = as_torch(x, enc, sm)
    loss, (loss_sum, out), grads = sam_gradients(
        lambda: tstep._loss_and_out(tm, xt, enc_t, smt), params, 0.05)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss_sum.item(), float(jsum), rtol=1e-5)
    want = poolresnet_state_dict(jax.tree.map(np.asarray, jgrads))
    for (name, p), g in zip(tm.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # the params are restored exactly
    for name, p in tm.named_parameters():
        assert torch.equal(p.detach(), poolresnet_state_dict(
            jax.tree.map(np.asarray, variables["params"]))[name]), name


def test_sgd_step_matches_fdtpu():
    jm, jstate, tx, jcfg, ts, tcfg = pair(dict(optimizer="sgd", learning_rate=1e-2))
    batch = data()
    jnew, jsc = jax_step(jm, tx, jcfg, jstate, batch)
    step = make_train_step(ts.module, tcfg, augment=False)
    ts, sc = step(ts, *as_torch(*batch))
    assert ts.step == int(jnew.step) == 1
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(sc["grad_norm"].item(), float(jsc["grad_norm"]), rtol=1e-4)
    assert_params_close(ts.module, jnew.params, atol=1e-6)


def test_adam_step_from_advanced_state_matches_fdtpu():
    jm, jstate, tx, jcfg, _, tcfg = pair(dict(learning_rate=1e-3))
    for seed in (0, 1):  # fdtpu advances its state twice
        jstate, _ = jax_step(jm, tx, jcfg, jstate, data(seed=seed))
    ts = train_state_from_fdtpu(jstate, torch_model(), tcfg, SPE)
    assert ts.step == 2
    batch = data(seed=2)
    jnew, jsc = jax_step(jm, tx, jcfg, jstate, batch)
    ts, sc = make_train_step(ts.module, tcfg, augment=False)(ts, *as_torch(*batch))
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=1e-5)
    assert_params_close(ts.module, jnew.params, atol=1e-6)
    adam = jnew.opt_state[0]
    mu = poolresnet_state_dict(jax.tree.map(np.asarray, adam.mu))
    for name, p in ts.module.named_parameters():
        st = ts.optimizer.state[p]
        assert st["step"].item() == int(adam.count) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(), rtol=1e-4, atol=1e-7)


def test_lr_schedule_matches_optax():
    cfg = dict(learning_rate=3e-4, lr_milestones=(2, 5), lr_gamma=0.1)
    got = make_lr_schedule(TrainConfig(**cfg), SPE)
    want = jax_make_lr_schedule(JaxTrainConfig(**cfg), SPE)
    for step in (0, 1, 19, 20, 21, 49, 50, 51, 1000):
        assert np.float32(got(step)) == np.float32(want(step)), step
    assert got(0) > got(20) > got(50)


def test_bf16_step_loss_matches_fdtpu():
    jm, jstate, tx, jcfg, ts, tcfg = pair(dict(optimizer="sgd", learning_rate=1e-2),
                                          dtype=jnp.bfloat16, compute_dtype=torch.bfloat16)
    batch = data(seed=3)
    jnew, jsc = jax_step(jm, tx, jcfg, jstate, batch)
    ts, sc = make_train_step(ts.module, tcfg, augment=False)(ts, *as_torch(*batch))
    assert all(p.dtype == torch.float32 for p in ts.module.parameters())
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=2e-3)
    np.testing.assert_allclose(sc["grad_norm"].item(), float(jsc["grad_norm"]), rtol=1e-2)


def test_eval_scalars_match_fdtpu_on_a_shared_output():
    jm, jstate, _, _, ts, _ = pair(dict(), seed=4)
    imgs, boxes, masks, sm = data(seed=5)
    nms = (0.5, 0.5, 64)
    want = jax_make_eval_step(jm, nms_params=nms)(
        jstate, *(jnp.asarray(a) for a in (imgs, boxes, masks, sm)))
    out = jm.apply({"params": jstate.params}, jnp.asarray(imgs, jnp.float32) / 255.0)
    enc, _ = jax_encode_targets(jm, jnp.asarray(boxes), jnp.asarray(masks), (160, 160))
    bx, bm, smt, out_t, enc_t = as_torch(boxes, masks, sm, out, enc)
    bm = bm & (bx[..., 3] * bx[..., 4] >= 10.0)
    loss_sum = (tstep.yolo_loss(out_t, enc_t) * smt).sum()
    got = tstep.eval_scalars(ts.module, out_t, loss_sum, bx, bm, smt, nms)
    assert float(got["iou"]) > 0
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-6)
    for k in ("iou", "recall", "precision"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    # the whole port eval step gives the same scalars from its own forward
    full = make_eval_step(ts.module, nms_params=nms)(ts, *as_torch(imgs, boxes, masks, sm))
    np.testing.assert_allclose(full["loss"].item(), float(want["loss"]), rtol=1e-5)
    scalars, (pb, pm) = make_eval_step(ts.module, nms_params=nms, return_boxes=True)(
        ts, *as_torch(imgs, boxes, masks, sm))
    assert pb.shape == (4, 64, 5) and pm.shape == (4, 64)


def test_detection_metrics_and_ap_match_fdtpu():
    rng = np.random.default_rng(8)
    b, p, g = 5, 12, 4
    pred = np.zeros((b, p, 5), np.float32)
    pred[..., 0] = rng.uniform(0.5, 1, (b, p))
    pred[..., 1:3] = rng.uniform(0, 100, (b, p, 2)).round()
    pred[..., 3:5] = rng.uniform(10, 60, (b, p, 2)).round()
    gt = pred[:, :g].copy()
    gt[..., 1:3] += rng.integers(-6, 7, (b, g, 2))
    pm = rng.uniform(size=(b, p)) > 0.3
    pm[0] = False  # no predictions: contributes 0
    gm = rng.uniform(size=(b, g)) > 0.2
    gm[1] = False  # predictions, no gt: recall 0
    sm = np.array([1, 1, 1, 1, 0], bool)
    got = detection_metrics(*as_torch(pred, pm, gt, gm, sm))
    want = jmetrics.detection_metrics(*(jnp.asarray(a) for a in (pred, pm, gt, gm, sm)))
    for k in ("iou", "recall", "precision"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    assert average_precision(*as_torch(pred, pm, gt, gm)) == jmetrics.average_precision(pred, pm, gt, gm)


def test_dropout_masks_replay():
    torch.manual_seed(0)
    m = torch_model(dropout=0.25)
    m.head_dropout.rate = 0.5
    x = torch.rand(2, *SIZE, 3)
    masks = DropoutMasks(torch.Generator().manual_seed(3))
    a = m(x, masks)
    masks.rewind()
    assert torch.equal(m(x, masks), a)  # both SAM points see the same masks
    assert not torch.equal(m(x, masks), a)  # without a rewind: new masks
    assert not torch.equal(m(x), a)  # no masks: no dropout
    h = torch.ones(64, 32, 4, 4)
    out = m.head_dropout(h, DropoutMasks(torch.Generator().manual_seed(1)))
    per_channel = out.flatten(2)
    assert ((per_channel == 0).all(-1) | (per_channel == 2.0).all(-1)).all()  # whole channels, x1/(1-rate)
    assert abs((per_channel[..., 0] == 0).float().mean().item() - 0.5) < 0.05


def test_whole_slice_on_cpu():
    """B = 16, bf16 compute, augmentation with rotation, dropout on, SAM +
    Adam: runs, stays finite, moves the params, repeats under one seed and
    ignores what a masked-out sample holds."""
    cfg = TrainConfig(learning_rate=1e-3, rotate_device=True, positional_crop=True, seed=3)
    imgs, boxes, masks, _ = data(b=16, seed=6)
    sm = np.ones(16, bool)
    sm[5] = False

    def run(images, steps=2, metrics=False):
        torch.manual_seed(0)
        m = torch_model(torch.bfloat16, dropout=0.25)
        state = create_train_state(m, cfg, SPE)
        step = make_train_step(m, cfg, compute_metrics=metrics)
        scalars = []
        for _ in range(steps):
            state, sc = step(state, *as_torch(images, boxes, masks, sm))
            scalars.append(sc)
        return state, scalars

    torch.manual_seed(0)
    start = [p.detach().clone() for p in torch_model().parameters()]
    state, scalars = run(imgs, metrics=True)
    assert state.step == 2
    for sc in scalars:
        assert all(torch.isfinite(v) for v in sc.values())
    assert {"iou", "recall", "precision"} <= set(scalars[-1])
    assert all(not torch.equal(p, q) for p, q in zip(state.module.parameters(), start))
    again, scalars2 = run(imgs, metrics=True)
    for p, q in zip(state.module.parameters(), again.module.parameters()):
        assert torch.equal(p, q)
    assert [s["loss"] for s in scalars] == [s["loss"] for s in scalars2]
    other = imgs.copy()
    other[5] = 255 - other[5]  # the masked-out sample
    masked, scalars3 = run(other)
    for p, q in zip(state.module.parameters(), masked.module.parameters()):
        assert torch.equal(p, q)


def test_unported_branches_raise():
    cfg = TrainConfig()
    with pytest.raises(NotImplementedError, match="item 5"):
        make_train_step(torch_model(), cfg, axis_name="data")
    with pytest.raises(ValueError, match="not a detector"):
        make_eval_step(torch.nn.Conv2d(3, 5, 1))
    with pytest.raises(ValueError):
        create_train_state(torch_model(), TrainConfig(optimizer="lamb"))
