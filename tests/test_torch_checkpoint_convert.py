"""``convert_fdtpu_checkpoint.py``: fdtpu's Orbax checkpoints into the port.

* PoolResnet (160 px, 16 filters, 2 blocks, Adam, SAM off, augmentation
  off): fdtpu's Trainer fits one epoch of 8 synthetic images at batch 4 and
  writes its Orbax checkpoint; the converter writes the port's ``.pt``; the
  port's ``Trainer.maybe_resume`` reads it at fdtpu's step and epoch, and
  one more epoch of each Trainer matches at ``tests/test_torch_trainer.py``'s
  float32 tolerances (epoch metrics rtol 1e-4, final params atol 1e-5). The
  eval forward of the resumed params matches fdtpu's at
  ``tests/test_torch_models.py``'s atol 2e-5.
* MobileNetV3 (with ``batch_stats``) and the SSD: fdtpu's state after one
  fdtpu Adam step, written with fdtpu's ``save_checkpoint``, converts bit for
  bit (params, BatchNorm statistics, Adam's moments and count); the next
  step matches fdtpu's: loss and grad norm rtol 1e-5, params atol 1e-5, the
  step count equal. MobileNetV3's ``bn3`` biases have no gradient but
  rounding noise, which Adam scales to a step of order ``lr`` either way;
  they are held to a step of at most ``1.5 lr`` on both sides, as in
  ``tests/test_torch_zoo.py``.
* A pruned bare variables tree (fdtpu's ``pruner.py`` logic and its
  ``--save`` form) converts at ``--filters`` of its kept width and serves:
  the eval forward atol 2e-5 and ``predict``'s boxes as
  ``tests/test_torch_slice.py``'s end to end.
* A tree of neither form, or of other widths, raises and names the
  mismatch; the port's ``restore_checkpoint`` refuses a variables-only file
  with a ValueError naming the missing optimizer state.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.compat.pruning import prune_l1_structured as jax_prune
from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import Detector as JaxDetector
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fdtpu.train.state import TrainState as JaxTrainState
from fdtpu.train.state import make_optimizer as jax_make_optimizer
from fdtpu.train.step import make_train_step as jax_make_train_step
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import state_dict_from_fdtpu
from fdtpu_torch.core import compact_boxes
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import SSD, Detector, MobileNetV3Backbone, PoolResnet
from fdtpu_torch.train import Trainer, create_train_state, make_train_step
from fdtpu_torch.train.checkpoint import restore_checkpoint, restore_variables
from fdtpu_torch.utils.config import TrainConfig

REPO = Path(__file__).resolve().parents[1]
SIZE = (160, 160)
S = 5
RTOL = 1e-4
PARAMS_ATOL = 1e-5
FORWARD_ATOL = 2e-5
NMS = (0.05, 0.5, 64)
FLAGS = ["--input", "160", "--patches", str(S), "--blocks", "2"]


def converter():
    spec = importlib.util.spec_from_file_location("convert_fdtpu_checkpoint",
                                                  REPO / "convert_fdtpu_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def frames(b=2, seed=0, size=SIZE):
    return np.random.default_rng(seed).uniform(0, 1, (b, *size, 3)).astype(np.float32)


# -- a Trainer checkpoint of PoolResnet -------------------------------------------------------


def config_kw(tmp, name):
    return dict(optimizer="adam", learning_rate=1e-3, use_sam=False, max_epochs=2, batch_size=4,
                box_capacity=4, visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                log_path=str(tmp / f"logs_{name}" / "out.log"), log_every_steps=0)


def loaders(root, source_cls, loader_cls, parse):
    train = source_cls(parse(root, "train", 3), SIZE, box_capacity=4, error_log=None,
                       use_native=False)
    val = source_cls(parse(root, "val", 3)[:6], SIZE, box_capacity=4, error_log=None,
                     use_native=False)
    return loader_cls(train, 4), loader_cls(val, 4)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """fdtpu's Trainer after one epoch (its checkpoint converted) and after
    two; the port's Trainer resumed from the conversion, before and after
    its second epoch."""
    tmp = tmp_path_factory.mktemp("trainer")
    for name, make in (("fdtpu", jax_make_synthetic), ("port", make_synthetic_widerface)):
        make(tmp / f"{name}_data", 8, split="train", seed=0)
        make(tmp / f"{name}_data", 8, split="val", seed=1)
    jm = JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                       dropout=0.0, head_dropout=0.0, dtype=jnp.float32)
    jt = JaxTrainer(jm, JaxTrainConfig(**config_kw(tmp, "fdtpu")),
                    *loaders(tmp / "fdtpu_data", JaxSource, JaxBatchLoader, jax_load_targets),
                    augment=False, nms_params=NMS, run_name="fdtpu")
    jt.fit(1)
    after_one = numpy_tree(jt.state.params)
    out = converter().main(["--checkpoint", str(tmp / "ckpt" / "fdtpu"),
                            "--out", str(tmp / "ckpt" / "port"), "--filters", "16", *FLAGS])
    tt = Trainer(PoolResnet(16, SIZE, S, 2, dropout=0.0, head_dropout=0.0),
                 TrainConfig(**config_kw(tmp, "port")),
                 *loaders(tmp / "port_data", WIDERFaceDataSource, BatchLoader, load_targets),
                 augment=False, nms_params=NMS, run_name="port", device="cpu")
    assert tt.maybe_resume()
    start = {"step": tt.state.step, "epoch": tt.epoch,
             "forward": tt.state.module.eval()(torch.from_numpy(frames())).detach().numpy()}
    jforward = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": after_one}, jnp.asarray(frames())))
    return {"jt": jt, "want": jt.fit(2), "tt": tt, "got": tt.fit(2), "start": start,
            "jforward": jforward, "out": out}


def test_trainer_resumes_at_fdtpus_step_and_epoch(resumed):
    assert resumed["out"].name == "step_00000002.pt"
    assert resumed["start"]["step"] == 2 and resumed["start"]["epoch"] == 1
    np.testing.assert_allclose(resumed["start"]["forward"], resumed["jforward"],
                               atol=FORWARD_ATOL, rtol=0)


def test_next_epoch_matches_fdtpus(resumed):
    jt, tt, got, want = resumed["jt"], resumed["tt"], resumed["got"], resumed["want"]
    assert tt.state.step == int(jt.state.step) == 4 and tt.epoch == jt.epoch == 2
    for split in ("train", "val"):
        assert list(got[split]) == list(want[split])
        for k in want[split]:
            np.testing.assert_allclose(got[split][k], want[split][k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"{split} {k}")
    wparams = state_dict_from_fdtpu(numpy_tree(jt.state.params), tt.state.module)
    for name, p in tt.state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), wparams[name].numpy(), atol=PARAMS_ATOL,
                                   rtol=0, err_msg=name)


# -- one fdtpu step of MobileNetV3 and of the SSD ---------------------------------------------


def filled_params(shapes, seed=0):
    """``shapes`` (from ``jax.eval_shape`` of an init) filled with torch's
    default init drawn by numpy: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
    a kernel and its bias, BatchNorm scale 1 and bias 0 (fdtpu's own init
    compiles for ~20 s here)."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        if "kernel" in tree:
            bound = 1 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
            return {k: jnp.asarray(rng.uniform(-bound, bound, v.shape).astype(np.float32))
                    for k, v in sorted(tree.items())}
        if "scale" in tree:
            return {"scale": jnp.ones(tree["scale"].shape), "bias": jnp.zeros(tree["bias"].shape)}
        return {k: fill(v) for k, v in sorted(tree.items())}

    return fill(shapes)


def random_stats(shapes, seed=2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
                                    if path[-1].key == "mean"
                                    else rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        shapes)


FAMILIES = {
    # name: (fdtpu module, the port's, size, the converter's flags)
    "mobilenetv3": (lambda: JaxMobileNetV3(SIZE, S, dtype=jnp.float32),
                    lambda: MobileNetV3Backbone(SIZE, S), SIZE,
                    ["--model", "mobilenetv3", *FLAGS]),
    "ssd": (lambda: JaxSSD(filters=4, input_shape=(64, 64), patch_sizes=(8, 4, 2, 1),
                           dropout=0.0, dtype=jnp.float32),
            lambda: SSD(4, (64, 64), (8, 4, 2, 1), dropout=0.0), (64, 64),
            ["--model", "ssd", "--input", "64", "--filters", "4"]),
}


def step_data(size, b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, *size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(0, size[0] * 0.7, (b, 4, 2)).round()
    boxes[..., 3:5] = rng.uniform(size[0] / 8, size[0] / 3, (b, 4, 2)).round()
    masks = rng.uniform(size=(b, 4)) > 0.3
    return imgs, boxes, masks, np.ones((b,), bool)


@pytest.fixture(scope="module", params=list(FAMILIES))
def stepped(request, tmp_path_factory):
    """fdtpu's state after one Adam step, saved by fdtpu and converted; one
    more step of each side from it."""
    make_jax, make_torch, size, flags = FAMILIES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jm = make_jax()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *size, 3)),
                                            train=False))
    params = filled_params(shapes["params"])
    stats = random_stats(shapes["batch_stats"]) if "batch_stats" in shapes else {}
    jcfg = JaxTrainConfig(learning_rate=1e-3, use_sam=False)
    tx = jax_make_optimizer(jcfg, 10)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params))
    jstep = jax.jit(jax_make_train_step(jm, tx, jcfg, augment=False, jit=False))

    def step(state, seed):
        return jstep(state, *(jnp.asarray(a) for a in step_data(size, seed=seed)),
                     jax.random.PRNGKey(0))

    jstate, _ = step(jstate, 0)
    jax_save_checkpoint(tmp / "fdtpu", jstate)
    out = converter().main(["--checkpoint", str(tmp / "fdtpu"), "--out", str(tmp / "port"),
                            *flags])
    tcfg = TrainConfig(learning_rate=1e-3, use_sam=False)
    ts = restore_checkpoint(out, create_train_state(make_torch(), tcfg, 10))
    converted = {"state": {k: v.clone() for k, v in ts.module.state_dict().items()},
                 "adam": {n: {k: v.clone() for k, v in ts.optimizer.state[p].items()}
                          for n, p in ts.module.named_parameters()}}
    jnew, jsc = step(jstate, 1)
    ts, sc = make_train_step(ts.module, tcfg, augment=False)(
        ts, *(torch.from_numpy(a) for a in step_data(size, seed=1)))
    return {"jstate": numpy_tree(jstate), "jnew": jnew, "jsc": jsc, "ts": ts, "sc": sc,
            "converted": converted}


def test_state_converts_bit_for_bit(stepped):
    jstate, ts, conv = stepped["jstate"], stepped["ts"], stepped["converted"]
    want = state_dict_from_fdtpu(jstate.params, ts.module, jstate.batch_stats or None)
    assert set(want) == set(conv["state"])
    for name, t in want.items():
        torch.testing.assert_close(conv["state"][name], t, rtol=0, atol=0, msg=name)
    adam = jstate.opt_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = state_dict_from_fdtpu(tree, ts.module)
        for name in dict(ts.module.named_parameters()):
            torch.testing.assert_close(conv["adam"][name][key], moments[name], rtol=0, atol=0,
                                       msg=f"{key} {name}")
    assert {float(a["step"]) for a in conv["adam"].values()} == {float(adam.count)} == {1.0}


def test_next_step_matches_fdtpus(stepped):
    jnew, jsc, ts, sc = stepped["jnew"], stepped["jsc"], stepped["ts"], stepped["sc"]
    assert ts.step == int(jnew.step) == 2
    np.testing.assert_allclose(sc["loss"].item(), float(jsc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(sc["grad_norm"].item(), float(jsc["grad_norm"]), rtol=1e-5)
    want = state_dict_from_fdtpu(numpy_tree(jnew.params), ts.module)
    lr, start = ts.optimizer.param_groups[0]["lr"], stepped["converted"]["state"]
    for name, p in ts.module.named_parameters():
        got = p.detach().numpy()
        if name.endswith("bn3.bias"):  # no gradient but rounding noise: tests/test_torch_zoo.py
            for after in (got, want[name].numpy()):
                assert np.abs(after - start[name].numpy()).max() <= 1.5 * lr, name
            continue
        np.testing.assert_allclose(got, want[name].numpy(), atol=PARAMS_ATOL, rtol=0,
                                   err_msg=name)


# -- a pruned variables tree, and trees that do not fit ---------------------------------------


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    """fdtpu's ``pruner.py`` on a 20-filter PoolResnet (amount 0.2: 16
    kept), saved as its ``--save`` writes it."""
    tmp = tmp_path_factory.mktemp("pruned")
    jm = JaxPoolResnet(filters=20, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                       dtype=jnp.float32)
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, *SIZE, 3)), train=False))(
        jax.random.PRNGKey(1))
    pm, pvars = jax_prune(jm, variables, 0.2)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((tmp / "pruned").absolute(), pvars, force=True)
    return {"tmp": tmp, "module": pm, "variables": pvars}


def test_pruned_variables_serve_at_the_kept_width(pruned):
    from fdtpu_torch import demo_model

    pm, pvars, tmp = pruned["module"], pruned["variables"], pruned["tmp"]
    assert pm.filters == 16
    out = converter().main(["--checkpoint", str(tmp / "pruned"), "--out", str(tmp / "port"),
                            "--filters", "16", *FLAGS])
    assert torch.load(out, weights_only=True)["step"] == 0
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_checkpoint(out, create_train_state(PoolResnet(16, SIZE, S, 2), TrainConfig()))
    # the demo's loading path, served in float32
    args = demo_model.parse_args(["--checkpoint", str(out), "--filters", "16", *FLAGS,
                                  "--device", "cpu"])
    det = Detector(demo_model.build_detector(args).module, 0.5, 0.3, 32, dtype=torch.float32)
    x = frames()
    np.testing.assert_allclose(det.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(pm.apply(pvars, jnp.asarray(x), train=False)),
                               atol=FORWARD_ATOL, rtol=0)
    jdet = JaxDetector(pm, pvars, 0.5, 0.3, 32)
    img = (frames(1, seed=5)[0] * 255).astype(np.uint8)
    _, jb, jmask = jdet.predict(img)
    _, boxes, mask = det.predict(img)
    got, want = compact_boxes(boxes, mask), compact_boxes(np.asarray(jb), np.asarray(jmask))
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1.0, rtol=0)
    assert restore_variables(out)["conv1.weight"].shape[0] == 16


def test_mismatched_trees_raise(pruned):
    tmp = pruned["tmp"]
    convert = converter().main
    with pytest.raises(ValueError, match=r"params\['Conv_0'\]\['bias'\] is \(16,\) there and "
                                         r"\(20,\) in the model"):
        convert(["--checkpoint", str(tmp / "pruned"), "--out", str(tmp / "wide"),
                 "--filters", "20", *FLAGS])
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((tmp / "other").absolute(), {"weights": {"w": np.zeros(3, np.float32)}},
                   force=True)
    with pytest.raises(ValueError, match="neither a Trainer checkpoint .* nor a variables tree"):
        convert(["--checkpoint", str(tmp / "other"), "--out", str(tmp / "x"),
                 "--filters", "16", *FLAGS])
    with pytest.raises(FileNotFoundError):
        convert(["--checkpoint", str(tmp / "missing"), "--out", str(tmp / "x"), *FLAGS])
    assert not (tmp / "wide").exists() and not (tmp / "x").exists()
