"""The rest of the zoo (Resnet, SeparableCNN, MobileNetV3-Small) against
fdtpu's, from the same params carried across by ``compat.from_fdtpu``, on
the same numpy inputs, at 160 px (filters 8, 2 blocks; MobileNetV3 at its
fixed widths).

Tolerances:

* float32 forwards: Resnet and SeparableCNN atol 1e-5 (summation order
  only, ~2e-7 measured); MobileNetV3 atol 1e-4, rtol 1e-4 (34 BatchNorms
  and the squeeze-excite gates carry the order further; ~1e-6 measured);
* bfloat16 forwards: atol 2^-7 on the sigmoid outputs, two bfloat16 steps
  at unit scale, as ``tests/test_torch_models.py`` states for PoolResnet.
  BatchNorm normalises a bfloat16 input in float32 with float32 params and
  statistics on both sides and rounds once;
* MobileNetV3 in train mode (batch statistics): the forward atol 1e-4, and
  the running statistics after one forward rtol 1e-5;
* BatchNorm state after one step of fdtpu's ``make_train_step``, with and
  without SAM: ``running_mean`` and ``running_var`` rtol 1e-5 (atol 1e-7
  for means near 0). An unbiased variance would be off by 1% at the final
  5x5 map of a b4 batch, and a second update from SAM's perturbed forward
  by far more;
* one SAM + Adam step from ``train_state_from_fdtpu`` (a state fdtpu
  advanced twice): loss and grad norm rtol 1e-5, params atol 1e-4;
* ``Detector.summary`` parameter totals: equal; the new ``core``
  functions: bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtpu.core import boxes as jax_boxes
from fdtpu.core import grid as jax_grid
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import Resnet as JaxResnet
from fdtpu.models import SeparableCNN as JaxSeparableCNN
from fdtpu.models.mobilenetv3 import make_divisible as jax_make_divisible
from fdtpu.train.state import create_train_state as jax_create_train_state
from fdtpu.train.step import make_train_step as jax_make_train_step
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import state_dict_from_fdtpu, train_state_from_fdtpu
from fdtpu_torch.core import boxes, grid
from fdtpu_torch.models import (
    Detector,
    MobileNetV3Backbone,
    PoolResnet,
    Resnet,
    SeparableCNN,
    build_model,
    has_batch_stats,
)
from fdtpu_torch.models.layers import BatchNorm, same_pads
from fdtpu_torch.models.mobilenetv3 import MOBILENETV3_SMALL, make_divisible
from fdtpu_torch.train import make_train_step
from fdtpu_torch.utils.config import DetectorConfig, TrainConfig

SIZE = (160, 160)
BF16_ATOL = 2.0 ** -7
FAMILIES = {
    # name: (fdtpu module at a dtype, the port's module), 160 px, filters 8, 2 blocks
    "resnet": (lambda dt: JaxResnet(8, SIZE, 5, 2, dtype=dt), lambda: Resnet(8, SIZE, 5, 2)),
    "separable": (lambda dt: JaxSeparableCNN(8, SIZE, 16, 2, dtype=dt),
                  lambda: SeparableCNN(8, SIZE, 16, 2)),
    "mobilenetv3": (lambda dt: JaxMobileNetV3(SIZE, 5, dtype=dt),
                    lambda: MobileNetV3Backbone(SIZE, 5)),
}
F32_TOL = {"resnet": dict(atol=1e-5, rtol=0), "separable": dict(atol=1e-5, rtol=0),
           "mobilenetv3": dict(atol=1e-4, rtol=1e-4)}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def with_random_stats(variables, seed=2):
    """fdtpu variables whose BatchNorm statistics are not the init's 0 and
    1 (means in [-0.5, 0.5], variances in [0.5, 1.5])."""
    variables = dict(numpy_tree(variables))
    if "batch_stats" in variables:
        rng = np.random.default_rng(seed)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
            if path[-1].key == "mean" else rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            variables["batch_stats"])
    return variables


@functools.lru_cache(maxsize=None)
def fdtpu_variables(family, seed=1):
    make_jax, _ = FAMILIES[family]
    init = jax.jit(lambda key: make_jax(jnp.float32).init(key, jnp.zeros((1, *SIZE, 3))))
    return with_random_stats(init(jax.random.PRNGKey(seed)))


def apply(jm, variables, x, **kw):
    """fdtpu's forward, jitted (eager Flax takes seconds a call)."""
    return jax.jit(functools.partial(jm.apply, **kw))(variables, jnp.asarray(x))


def pair(family, dtype=jnp.float32, seed=1):
    """An fdtpu model with fresh params (and random BatchNorm statistics),
    and the port's model carrying them."""
    make_jax, make_torch = FAMILIES[family]
    jm = make_jax(dtype)
    variables = fdtpu_variables(family, seed)
    tm = make_torch()
    tm.load_state_dict(state_dict_from_fdtpu(variables["params"], tm,
                                             variables.get("batch_stats")))
    return jm, variables, tm


def images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(b, *SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_f32_matches_fdtpu(family):
    jm, variables, tm = pair(family)
    x = images()
    want = np.asarray(apply(jm, variables, x, train=False))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    s = jm.grid_size()
    assert tm.grid_size() == s and got.shape == want.shape == (2, s, s, 5)
    np.testing.assert_allclose(got, want, **F32_TOL[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_bf16_matches_fdtpu(family):
    jm, variables, tm = pair(family, dtype=jnp.bfloat16)
    x = images(seed=1)
    want = np.asarray(apply(jm, variables, x, train=False))
    det = Detector(tm, dtype=torch.bfloat16)
    got = det.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # BatchNorm keeps float32 params and statistics in the bfloat16 copy
    assert all(t.dtype == torch.float32 for m in det.net.modules() if isinstance(m, BatchNorm)
               for t in m.state_dict().values())
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_mobilenetv3_train_mode_uses_batch_statistics():
    """``train=True`` normalises by the batch's statistics and folds them
    into the running ones by Flax's rule; ``.eval()`` or ``.train()`` on the
    module changes nothing, the argument decides."""
    jm, variables, tm = pair("mobilenetv3")
    x = images(b=4, seed=2)
    want, updates = apply(jm, variables, x, train=True, mutable=["batch_stats"])
    tm.eval()  # the flag, not the module's mode
    got = tm(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    stats = state_dict_from_fdtpu(variables["params"], tm, numpy_tree(updates["batch_stats"]))
    for name, t in tm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    tm.train()
    frozen = {k: v.clone() for k, v in tm.state_dict().items()}
    eval_out = tm(torch.from_numpy(x)).detach().numpy()  # running statistics, no update
    np.testing.assert_allclose(
        eval_out, np.asarray(apply(jm, {**variables, "batch_stats": updates["batch_stats"]}, x,
                                   train=False)), atol=1e-4, rtol=1e-4)
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in frozen.items())
    assert not np.allclose(eval_out, got, atol=1e-3)
    tm(torch.from_numpy(x), train=True, update_stats=False)
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in frozen.items())


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("n", [15, 30, 31, 96, 100, 480])
def test_same_pads_match_flax(k, s, n):
    assert same_pads(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_same_pads_of_strided_layers():
    """A k3/s2 conv at 480 px pads one row after and none before; a k5/s2
    conv at 30 px one before and two after."""
    assert same_pads(480, 3, 2) == (0, 1)
    assert same_pads(30, 5, 2) == (1, 2)


def test_mobilenetv3_table_and_se_widths():
    assert make_divisible(0.9 * 30) == jax_make_divisible(0.9 * 30)
    se = [make_divisible(exp * 0.25) for _, exp, _, use_se, _, _ in MOBILENETV3_SMALL if use_se]
    assert se == [jax_make_divisible(e * 0.25) for _, e, _, u, _, _ in MOBILENETV3_SMALL if u]
    assert se == [8, 24, 64, 64, 32, 40, 72, 144, 144]
    m = MobileNetV3Backbone(SIZE, 5)
    assert m.blocks[0].conv_pw is None and m.blocks[1].conv_pw is not None
    assert [b.residual for b in m.blocks] == [False, False, True, False, True, True, False,
                                              True, False, True, True]
    assert m.blocks[0].se.reduce.bias is not None and m.blocks[0].conv_dw.bias is None
    bn = m.bn1
    assert (bn.eps, bn.momentum) == (1e-3, 0.99) and not hasattr(bn, "num_batches_tracked")


# -- BatchNorm state through fdtpu's train step --------------------------------------


def step_data(b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, *SIZE, 3), dtype=np.uint8)
    boxes_ = np.zeros((b, 4, 5), np.float32)
    boxes_[..., 0] = 1.0
    boxes_[..., 1:3] = rng.uniform(0, 110, (b, 4, 2)).round()
    boxes_[..., 3:5] = rng.uniform(20, 50, (b, 4, 2)).round()
    masks = rng.uniform(size=(b, 4)) > 0.3
    return imgs, boxes_, masks, np.ones((b,), bool)


def jax_step(jstep, jstate, batch):
    return jstep(jstate, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=[True, False], ids=["sam-adam", "plain-sgd"])
def stepped(request):
    """fdtpu's MobileNetV3 state advanced twice, then one step more from it;
    the port's step from the same (converted) state. SAM with Adam, or no
    SAM with SGD, float32, augmentation off."""
    use_sam = request.param
    kw = dict(use_sam=use_sam, optimizer="adam" if use_sam else "sgd",
              learning_rate=1e-3 if use_sam else 1e-2)
    jm = JaxMobileNetV3(SIZE, 5, dtype=jnp.float32)
    jcfg = JaxTrainConfig(**kw)
    jstate, tx = jax_create_train_state(jm, jcfg, jax.random.PRNGKey(3), 10)
    jstep = jax_make_train_step(jm, tx, jcfg, augment=False, jit=False)
    jstep = jax.jit(jstep)  # no donation: the state is read again below
    for seed in (0, 1):
        jstate, _ = jax_step(jstep, jstate, step_data(seed=seed))
    tcfg = TrainConfig(**kw)
    ts = train_state_from_fdtpu(jstate, MobileNetV3Backbone(SIZE, 5), tcfg, 10)
    before = {k: v.clone() for k, v in ts.module.state_dict().items()}
    batch = step_data(seed=2)
    jnew, jsc = jax_step(jstep, jstate, batch)
    ts, sc = make_train_step(ts.module, tcfg, augment=False)(
        ts, *(torch.from_numpy(a) for a in batch))
    return {"jstate": jstate, "jnew": jnew, "jsc": jsc, "ts": ts, "sc": sc, "before": before}


def test_bn_state_after_one_step_matches_fdtpu(stepped):
    jnew, ts, before = stepped["jnew"], stepped["ts"], stepped["before"]
    want = state_dict_from_fdtpu(numpy_tree(jnew.params), ts.module,
                                 numpy_tree(jnew.batch_stats))
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 34
    for name in names:
        got = ts.module.state_dict()[name]
        assert not torch.equal(got, before[name]), name  # the step moved it
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_mobilenetv3_step_matches_fdtpu(stepped):
    """Loss and grad norm rtol 1e-5; params atol 1e-4 and the step count.

    One kind of tensor has no gradient to match: the bias of each block's
    last BatchNorm (``bn3``). A shift there reaches the loss only through a
    later 1x1 convolution and a BatchNorm on batch statistics (the next
    block's ``bn1``, or ``bn_576``; a residual add carries it on to one),
    which subtracts it again, so its gradient is 0 up to rounding. Adam
    scales that rounding noise to a step of order ``lr`` on each side, in
    no particular direction. Those tensors are held to what Adam can do
    with any gradient (a step of at most ``1.5 lr`` after three steps,
    from where both sides started) and their gradients to ~0 beside the
    others'."""
    jnew, jsc, ts, sc = stepped["jnew"], stepped["jsc"], stepped["ts"], stepped["sc"]
    assert ts.step == int(jnew.step) == 3
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(sc["grad_norm"].item(), float(jsc["grad_norm"]), rtol=1e-5)
    lr = ts.optimizer.param_groups[0]["lr"]
    want = state_dict_from_fdtpu(numpy_tree(jnew.params), ts.module)
    start = stepped["before"]
    for name, p in ts.module.named_parameters():
        got = p.detach().numpy()
        if name.endswith("bn3.bias"):
            for after in (got, want[name].numpy()):
                assert np.abs(after - start[name].numpy()).max() <= 1.5 * lr, name
            continue
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)


def test_bn3_bias_gradient_is_rounding_noise():
    """The premise of the exception above, on the port: the ``bn3`` biases'
    gradients are ~0 against the other tensors' under train-mode BatchNorm."""
    _, variables, tm = pair("mobilenetv3")
    x = torch.from_numpy(images(b=4, seed=3))
    loss = tm(x, train=True, update_stats=False)[..., 0].square().sum()
    grads = dict(zip([n for n, _ in tm.named_parameters()],
                     torch.autograd.grad(loss, list(tm.parameters()))))
    noise = max(g.abs().max().item() for n, g in grads.items() if n.endswith("bn3.bias"))
    other = max(g.abs().max().item() for n, g in grads.items() if n.endswith("bn2.bias"))
    assert noise < 1e-4 * other


# -- construction, conversion, summary, core -----------------------------------------


def test_build_model_builds_every_family():
    cfg = DetectorConfig(filters=8, input_shape=SIZE, num_patches=5, num_residual_blocks=2)
    kinds = {"poolresnet": PoolResnet, "resnet": Resnet, "separable": SeparableCNN,
             "mobilenetv3": MobileNetV3Backbone}
    for name, cls in kinds.items():
        m = build_model(name, cfg, "cpu", torch.Generator().manual_seed(0))
        assert type(m) is cls and has_batch_stats(m) == (name == "mobilenetv3"), name
        assert all(p.dtype == torch.float32 and not p.is_cuda for p in m.parameters())
    assert build_model("resnet", cfg, "cpu").grid_size() == JaxResnet(8, SIZE, 5, 2).grid_size()
    assert build_model("mobilenetv3", DetectorConfig(num_patches=15), "cpu").grid_size() == 15


def test_state_dict_from_fdtpu_dispatches_by_class():
    _, variables, _ = pair("separable")
    with pytest.raises(ValueError):  # a SeparableCNN tree is not a Resnet's
        state_dict_from_fdtpu(variables["params"], Resnet(8, SIZE, 5, 2))
    with pytest.raises(ValueError, match="no converter"):
        state_dict_from_fdtpu(variables["params"], torch.nn.Conv2d(3, 5, 1))
    sd = state_dict_from_fdtpu(variables["params"], SeparableCNN(8, SIZE, 16, 2))
    kernel = np.asarray(variables["params"]["SeparableResidualBlock_1"]["Conv_1"]["kernel"])
    assert kernel.shape == (3, 3, 1, 8)  # depthwise HWIO
    np.testing.assert_array_equal(sd["residual_blocks.1.depthwise_conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    assert "residual_blocks.0.pointwise_conv1.bias" not in sd


@pytest.mark.parametrize("family", list(FAMILIES))
def test_summary_param_totals_match_fdtpu(family):
    jm, variables, tm = pair(family)
    rows = Detector(tm, dtype=torch.float32).summary_rows()
    name, kind, params, buffers, flops = rows[0]
    assert name == "total" and kind == type(tm).__name__
    assert params == sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert buffers == sum(a.size for a in jax.tree.leaves(variables.get("batch_stats", {})))
    assert flops > 0 and all(r[4] <= flops for r in rows)
    assert "total" in Detector(tm).summary()


@pytest.mark.parametrize("fn", ["cxywh_to_xyxy", "cxyxy_to_xywh"])
def test_box_conversions_bit_equal_fdtpu(fn):
    x = np.random.default_rng(3).uniform(0, 300, size=(4, 7, 5)).astype(np.float32)
    got = getattr(boxes, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jax_boxes, fn)(jnp.asarray(x))))


def test_masked_box_iou_bit_equal_fdtpu():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 200, (2, 2, 12, 2)).astype(np.float32)
    wh = rng.uniform(-5, 80, (2, 2, 12, 2)).astype(np.float32)
    a, b = np.concatenate([xy, xy + wh], -1)
    a[0, 3] = b[0, 5] = [10, 10, 50, 60]
    am, bm = rng.uniform(size=(2, 2, 12)) > 0.3
    got = boxes.masked_box_iou(*(torch.from_numpy(v) for v in (a, am, b, bm))).numpy()
    want = np.asarray(jax_boxes.masked_box_iou(*(jnp.asarray(v) for v in (a, am, b, bm))))
    np.testing.assert_array_equal(got, want)
    assert (got[~(am[..., :, None] & bm[..., None, :])] == 0).all()


def test_reference_layout_converters_bit_equal_fdtpu():
    fm = np.random.default_rng(5).uniform(size=(5, 7, 7)).astype(np.float32)
    got = grid.reference_fm_to_fdtpu(torch.from_numpy(fm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_grid.reference_fm_to_fdtpu(fm)))
    back = grid.fdtpu_fm_to_reference(got)
    np.testing.assert_array_equal(back.numpy(), fm)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_grid.fdtpu_fm_to_reference(got.numpy())))
