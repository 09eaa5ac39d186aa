"""The serving and eval programs that replay from CUDA graphs on a card
(``utils/graphs.py``, ``models/detector.py``, ``train/graphs.py``), here on
the CPU, where they run eagerly:

* a ``Detector``'s ``predict`` (three kinds of frame, two threshold pairs)
  and ``non_max_suppression`` against fdtpu's ``Detector`` on shared params
  (float32), at ``tests/test_torch_slice.py``'s tolerances: the normalised
  image within 1e-6, the kept boxes' scores within 2e-5 and coordinates
  within a pixel end to end (fdtpu serves below b8 through its XLA twin,
  whose kept rows are not compacted: the ragged views are compared); K1 on
  one forward output bit-equal in masks and scores, coordinates within
  1e-4;
* the port's Trainer against fdtpu's, streamed and resident (fdtpu's
  ``_device_eval_jit``), eval epochs only, from shared params, for a tiny
  PoolResnet and a tiny SSD: every metric within rtol 1e-5;
  ``run_validation_epoch`` on a checkpoint of those params against fdtpu's
  ``Trainer.test``, the same bar (its module computes in float32 here, as
  fdtpu's side does);
* what refuses: the capture helper and ``CapturedEvalStep`` raise
  ValueError on a CPU device, ``CapturedEvalStep`` over a gloo group;
  building a Detector captures nothing;
* the graph key (a pure function of the program, shape, dtype, thresholds
  rounded to float32 and capacity) and the least-recently-used cache.

On a card, replay = eager bit for bit: ``tests/test_torch_serve_graphs_card.py``
(``gpu``, no jax) and ``chip_smoke.py`` phase 22.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_threads  # noqa: F401  (torch's threads under xdist)

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.kernels import grid_decode_tables, pallas_decode_filter_nms_batch
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import Detector as JaxDetector
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch import run_validation_epoch
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.compat.from_fdtpu import state_dict_from_fdtpu
from fdtpu_torch.core import compact_boxes
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import SSD, Detector, PoolResnet
from fdtpu_torch.models.detector import MAX_GRAPHS, graph_key
from fdtpu_torch.train import Trainer, make_eval_step
from fdtpu_torch.train.checkpoint import save_checkpoint
from fdtpu_torch.train.graphs import CapturedEvalStep
from fdtpu_torch.train.state import create_train_state
from fdtpu_torch.utils import graphs
from fdtpu_torch.utils.config import TrainConfig

SIZE = (160, 160)
S = 5
PROB, IOU, CAP = 0.5, 0.3, 32
THRESHOLDS = ((0.5, 0.5), (0.7, 0.01))
EVAL_RTOL = 1e-5
# a low threshold, so that the fresh model's boxes reach the metrics; the
# capacity run_validation_epoch takes for the family
NMS = {"poolresnet": (0.05, 0.5, 64), "ssd": (0.05, 0.5, 128)}
SSD_SIZE, SSD_PS, SSD_F = (64, 64), (8, 4, 2, 1), 4


# -- predict and non_max_suppression -----------------------------------------------------


@pytest.fixture(scope="module")
def detectors():
    jm = JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                       dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, *SIZE, 3)))
    tm = PoolResnet(16, SIZE, S, 2)
    tm.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"])))
    return JaxDetector(jm, variables, PROB, IOU, CAP), Detector(tm, PROB, IOU, CAP,
                                                                 dtype=torch.float32)


def frame(kind: str, seed: int):
    """A model-size u8 frame, a 640x480 u8 frame (resized through PIL) or a
    model-size float frame in [0, 255]."""
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, size=(*SIZE, 3), dtype=np.uint8)
    if kind == "vga":
        return rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    return rng.uniform(0, 255, size=(*SIZE, 3)).astype(np.float32)


def assert_end_to_end(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1.0, rtol=0)


@pytest.mark.parametrize("prob,iou", THRESHOLDS)
@pytest.mark.parametrize("kind", ["u8", "vga", "float"])
def test_predict_matches_fdtpu(detectors, kind, prob, iou):
    """fdtpu resizes on the device (``jax.image.resize``), the port on the
    host through PIL: the 640x480 frame goes to both already resized by
    :meth:`Detector.host_frame`, so both see the same pixels."""
    jdet, tdet = detectors
    img = tdet.host_frame(frame(kind, seed={"u8": 0, "vga": 1, "float": 2}[kind]))
    assert img.shape == (*SIZE, 3)
    jnorm, jb, jm = jdet.predict(img, prob, iou)
    norm, boxes, mask = tdet.predict(img, prob, iou)
    assert boxes.shape == (CAP, 5) and mask.shape == (CAP,) and norm.shape == (*SIZE, 3)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), atol=1e-6, rtol=0)
    assert mask.any()
    assert_end_to_end(compact_boxes(boxes, mask), compact_boxes(jb, jm))
    assert len(tdet._graphs) == 0  # the CPU runs eagerly


@pytest.mark.parametrize("b", [1, 3])
def test_non_max_suppression_matches_fdtpu(detectors, b):
    jdet, tdet = detectors
    u8 = np.random.default_rng(b).integers(0, 256, size=(b, *SIZE, 3), dtype=np.uint8)
    jout = np.asarray(jdet.apply(jnp.asarray(u8, jnp.float32) / 255.0))
    tout = tdet.apply(torch.from_numpy(u8).float() / 255.0)
    np.testing.assert_allclose(tout.numpy(), jout, atol=2e-5, rtol=0)
    boxes, mask = tdet.non_max_suppression(torch.tensor(jout))
    wb, wm = pallas_decode_filter_nms_batch(jnp.asarray(jout).reshape(b, S * S, 5),
                                            grid_decode_tables(S, SIZE), PROB, IOU, CAP,
                                            interpret=True)
    wb, wm = np.asarray(wb), np.asarray(wm)
    np.testing.assert_array_equal(mask.numpy(), wm)
    np.testing.assert_array_equal(boxes.numpy()[..., 0], wb[..., 0])
    np.testing.assert_allclose(boxes.numpy()[..., 1:], wb[..., 1:], atol=1e-4, rtol=0)
    jb, jm = jdet.non_max_suppression(jnp.asarray(jout))  # fdtpu's own (XLA's below b8)
    for i in range(b):
        assert_end_to_end(compact_boxes(boxes[i], mask[i]), compact_boxes(jb[i], jm[i]))
    boxes, mask = tdet.non_max_suppression(tout)  # end to end
    for i in range(b):
        assert_end_to_end(compact_boxes(boxes[i], mask[i]), wb[i][wm[i]])


# -- the Trainer's eval epochs and run_validation_epoch -----------------------------------


def jax_module(family: str):
    if family == "poolresnet":
        return JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                             dropout=0.0, head_dropout=0.0, dtype=jnp.float32)
    return JaxSSD(filters=SSD_F, input_shape=SSD_SIZE, patch_sizes=SSD_PS, dropout=0.0,
                  dtype=jnp.float32)


def torch_module(family: str):
    if family == "poolresnet":
        return PoolResnet(16, SIZE, S, 2, dropout=0.0, head_dropout=0.0)
    return SSD(SSD_F, SSD_SIZE, SSD_PS, dropout=0.0)


def loader_pair(root, family: str, source, loader, parse):
    shape = SIZE if family == "poolresnet" else SSD_SIZE
    val = source(parse(root, "val", 3), shape, box_capacity=4, error_log=None, use_native=False)
    return loader(val, 4)


@pytest.fixture(scope="module", params=["poolresnet", "ssd"])
def eval_runs(request, tmp_path_factory):
    """fdtpu's Trainer and the port's, streamed and resident, from the same
    params; the eval epoch of each on 6 val images at batch 4 (the last
    batch padded), before any training."""
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    jroot, root = tmp / "fdtpu_data", tmp / "port_data"
    for r, make in ((jroot, jax_make_synthetic), (root, make_synthetic_widerface)):
        make(r, 6, split="val", seed=1)
    out = {"family": family, "root": root, "tmp": tmp}
    for resident in (False, True):
        kw = dict(max_epochs=1, batch_size=4, box_capacity=4, visualize_first_batch=False,
                  device_data=resident, checkpoint_dir=str(tmp / "ckpt"), log_every_steps=0)
        jval = loader_pair(jroot, family, JaxSource, JaxBatchLoader, jax_load_targets)
        jt = JaxTrainer(jax_module(family), JaxTrainConfig(
            log_path=str(tmp / f"jlogs{resident}" / "out.log"), **kw), jval, jval,
            augment=False, nms_params=NMS[family], run_name="fdtpu")
        module = torch_module(family)
        module.load_state_dict(state_dict_from_fdtpu(jax.tree.map(np.asarray, jt.state.params),
                                                     module))
        val = loader_pair(root, family, WIDERFaceDataSource, BatchLoader, load_targets)
        tt = Trainer(module, TrainConfig(log_path=str(tmp / f"logs{resident}" / "out.log"), **kw),
                     val, val, augment=False, nms_params=NMS[family], run_name="port",
                     device="cpu")
        feed = "resident" if resident else "streamed"
        out[feed] = (jt.eval_epoch(), tt.eval_epoch(), tt, jt)
    return out


def assert_metrics_close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("feed", ["streamed", "resident"])
def test_eval_epoch_matches_fdtpu(eval_runs, feed):
    want, got, tt, jt = eval_runs[feed]
    assert type(tt.driver).__name__ == type(jt.driver).__name__
    assert not tt.replaying and tt.runner("eval") is tt.eval_step  # eager on the CPU
    assert_metrics_close(got, want)
    assert set(want) == {"loss", "iou", "recall", "precision", "f1"}
    if eval_runs["family"] == "poolresnet":
        assert want["iou"] > 0  # the decoded boxes reach the metrics


def test_run_validation_epoch_matches_fdtpu(eval_runs, monkeypatch):
    """``run_validation_epoch`` on a checkpoint of the shared params (batch
    4, the CPU) against fdtpu's ``Trainer.test`` on the loader it builds
    (box capacity 8, or the SSD pipeline's 128 and <120-face filter). Both
    decode with PIL and compute in float32 (the entry point's module takes
    ``DetectorConfig.dtype``, bfloat16, which fdtpu's float32 side does
    not)."""
    family, tmp = eval_runs["family"], eval_runs["tmp"]
    _, _, tt, jt = eval_runs["streamed"]
    path = save_checkpoint(tmp / "rve", create_train_state(tt.module, TrainConfig()))
    monkeypatch.setitem(run_validation_epoch.DTYPES, "bfloat16", torch.float32)
    monkeypatch.setattr(run_validation_epoch, "WIDERFaceDataSource",
                        functools.partial(WIDERFaceDataSource, use_native=False))
    monkeypatch.chdir(tmp)
    args = ["--data-dir", str(eval_runs["root"]), "--model", family, "--checkpoint", str(path),
            "--batch-size", "4", "--device", "cpu", "--prob-threshold", str(NMS[family][0]),
            "--iou-threshold", str(NMS[family][1])]
    if family == "poolresnet":
        args += ["--input", str(SIZE[0]), "--patches", str(S), "--filters", "16", "--blocks", "2"]
    else:
        args += ["--input", str(SSD_SIZE[0]), "--filters", str(SSD_F)]
    got = run_validation_epoch.main(args)
    max_faces, capacity, shape = (3, 8, SIZE) if family == "poolresnet" else (120, 128, SSD_SIZE)
    loader = JaxBatchLoader(JaxSource(jax_load_targets(tmp / "fdtpu_data", "val", max_faces),
                                      shape, capacity, use_native=False), 4)
    assert_metrics_close(got, jt.test(loader))


# -- refusals, the key and the cache -------------------------------------------------------


def small_eval(family="poolresnet"):
    module = torch_module(family)
    return create_train_state(module, TrainConfig()), make_eval_step(
        module, nms_params=NMS[family], return_boxes=True)


def test_capture_helper_raises_on_the_cpu():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="needs a card"):
        graphs.capture_body(lambda t: t + 1, (x,))
    with pytest.raises(ValueError, match="needs a card"):
        graphs.capture(lambda: x + 1, x.device)
    with pytest.raises(ValueError, match="needs a card"):
        graphs.warm_up(lambda: x + 1, x.device, 1)


@pytest.mark.parametrize("form", ["batch", "gather"])
def test_captured_eval_step_raises_on_the_cpu(form):
    state, step = small_eval()
    captured = CapturedEvalStep(step)
    batch = (torch.zeros((2, *SIZE, 3), dtype=torch.uint8), torch.zeros((2, 4, 5)),
             torch.zeros((2, 4), dtype=torch.bool), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="needs a card"):
        if form == "batch":
            captured(state, *batch)
        else:
            captured.gather(state, batch, torch.arange(2))
    assert not captured.graphs and captured.replays == 0


def test_captured_eval_step_refuses_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        module = torch_module("poolresnet")
        with pytest.raises(ValueError, match="gloo"):
            CapturedEvalStep(make_eval_step(module, group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def test_eval_step_is_its_prologue_and_body():
    """The eager step is the default ``sample_mask`` then ``step.body``, the
    part a graph captures."""
    state, step = small_eval()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, *SIZE, 3), dtype=np.uint8))
    boxes = torch.tensor([[[1.0, 10, 20, 40, 50]] * 4] * 2)
    mask = torch.tensor([[True, False, False, False]] * 2)
    scalars, (pb, pm) = step(state, images, boxes, mask)
    body_scalars, (bb, bm) = step.body(state, images, boxes, mask, torch.ones(2, dtype=torch.bool))
    assert scalars.keys() == body_scalars.keys() == {"loss", "iou", "recall", "precision"}
    for k in scalars:
        assert torch.equal(scalars[k], body_scalars[k]), k
    assert torch.equal(pb, bb) and torch.equal(pm, bm)
    assert step.group is None and step.mesh is None


def test_building_a_detector_captures_nothing():
    det = Detector(torch_module("poolresnet"), dtype=torch.float32)
    assert len(det._graphs) == 0 and det._pool is None and not det._staging
    det.predict(frame("u8", 0))
    det.non_max_suppression(det.apply(torch.zeros((1, *SIZE, 3))))
    assert len(det._graphs) == 0 and det._pool is None  # eager on the CPU


def test_graph_key():
    key = graph_key("predict", (160, 160, 3), torch.uint8, 0.5, 0.5, 64)
    assert key == graph_key("predict", [160, 160, 3], torch.uint8, 0.5, 0.5, 64)
    assert hash(key) == hash(graph_key("predict", (160, 160, 3), torch.uint8, 0.5, 0.5, 64))
    # thresholds that round to one float32 give one key
    near = float(np.nextafter(0.7, 1.0))
    assert np.float32(near) == np.float32(0.7)
    assert graph_key("predict", (160, 160, 3), torch.uint8, near, 0.01, 64) == \
        graph_key("predict", (160, 160, 3), torch.uint8, 0.7, 0.01, 64)
    others = [graph_key("nms", (160, 160, 3), torch.uint8, 0.5, 0.5, 64),
              graph_key("predict", (96, 160, 3), torch.uint8, 0.5, 0.5, 64),
              graph_key("predict", (160, 160, 3), torch.float32, 0.5, 0.5, 64),
              graph_key("predict", (160, 160, 3), torch.float64, 0.5, 0.5, 64),
              graph_key("predict", (160, 160, 3), torch.uint8, 0.51, 0.5, 64),
              graph_key("predict", (160, 160, 3), torch.uint8, 0.5, 0.01, 64),
              graph_key("predict", (160, 160, 3), torch.uint8, 0.5, 0.5, 128)]
    assert len({key, *others}) == 1 + len(others)


def test_graph_cache_evicts_the_least_recently_used():
    cache = graphs.GraphCache(3)
    made = []

    def make(k):
        def f():
            made.append(k)
            return f"graph {k}"
        return f

    for k in "abc":
        assert cache.get(k, make(k)) == f"graph {k}"
    assert cache.get("a", make("a")) == "graph a" and made == list("abc")  # a hit
    cache.get("d", make("d"))  # b, the least recently used, goes
    assert list(cache.graphs) == list("cad") and len(cache) == 3
    cache.get("b", make("b"))
    assert made == list("abcdb") and list(cache.graphs) == list("adb")
    assert MAX_GRAPHS == 8
