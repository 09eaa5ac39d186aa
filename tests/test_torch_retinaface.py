"""RetinaFace-R50 in the port (``models/retinaface.py``, ``core/priors.py``'s
anchored priors, K1's indexed op, ``Detector.predict``'s landmarks)
against the plain float32 reference of the benchmark
(``perfbench/reference/retinaface.py``) on the CPU: full depth at the
reference's ``TINY`` widths and input, seeded weights."""

import collections
import itertools
import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from fdtpu_torch.core.priors import anchor_priors, feature_maps
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import Detector, build_model
from fdtpu_torch.utils import graphs, trace
from fdtpu_torch.utils.config import RetinaFaceConfig
from perfbench import data, program, weights
from perfbench.cell import reader
from perfbench.reference import retinaface as ref
from perfbench.reference.nn import Precision
from perfbench.reference.serve import greedy_kept

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "retinaface-r50-840.json").read_text())
FULL = CONFIG["model"]
TINY = {**FULL, **ref.TINY}  # 64 px, 168 priors, out_channel 72 (ReLU)
TINY_LEAKY = {**TINY, "out_channel": 16}  # net.py's LeakyReLU(0.1) below 65 channels
SEEDS = (1, 2, 3)


def published_priors(min_sizes, steps, image_size):
    """``layers/functions/prior_box.py``'s ``PriorBox.forward``, as
    published (clip off)."""
    maps = [[math.ceil(image_size[0] / s), math.ceil(image_size[1] / s)] for s in steps]
    anchors = []
    for k, f in enumerate(maps):
        for i, j in itertools.product(range(f[0]), range(f[1])):
            for min_size in min_sizes[k]:
                s_kx, s_ky = min_size / image_size[1], min_size / image_size[0]
                cx, cy = (j + 0.5) * steps[k] / image_size[1], (i + 0.5) * steps[k] / image_size[0]
                anchors += [cx, cy, s_kx, s_ky]
    return torch.Tensor(anchors).view(-1, 4)


def tiny_case(model: dict, seed: int, frames: int = 4):
    """Weights from the seed with the scores centred as the stream cell
    centres them, the program's float32 module holding them, and frames."""
    params = weights.draw(ref.param_specs(model), seed, "cpu")
    pool, _, _ = data.faces(seed, "frames", frames, model["input_shape"][0], 750, 12, "cpu")
    weights.center_scores(ref, params, model, pool, 50)
    net = program.module({**CONFIG, "model": model}, params, "cpu", train=False)
    return params, net, pool


# -- priors ----------------------------------------------------------------------------


@pytest.mark.parametrize("size", [840, 64])
def test_priors_follow_prior_box(size):
    got = anchor_priors(tuple(map(tuple, FULL["min_sizes"])), tuple(FULL["steps"]), (size, size))
    want = published_priors(FULL["min_sizes"], FULL["steps"], (size, size))
    assert torch.equal(got, want)
    maps = feature_maps((size, size), tuple(FULL["steps"]))
    assert got.shape == (2 * sum(r * c for r, c in maps), 4)
    if size == 840:
        assert maps == [(105, 105), (53, 53), (27, 27)] and got.shape[0] == 29126
        assert got[0].tolist() == pytest.approx([4 / 840, 4 / 840, 16 / 840, 16 / 840])
        assert got[1].tolist() == pytest.approx([4 / 840, 4 / 840, 32 / 840, 32 / 840])
        # the last: level 3's bottom-right cell, its 512 px anchor
        assert got[-1].tolist() == pytest.approx([26.5 * 32 / 840] * 2 + [512 / 840] * 2)
    assert torch.equal(ref.priors({**FULL, "input_shape": [size, size]}, "cpu"), want)


def test_the_published_model_size():
    """27.29 M parameters, as the published RetinaFace-R50; 29,126 priors
    and 154.7 GFLOP a forward at 840 px."""
    net = build_model("retinaface", RetinaFaceConfig(), "meta")
    assert sum(p.numel() for p in net.parameters()) == 27_293_600
    assert net.num_priors() == 29126
    assert ref.flop_counts(FULL)[0] == pytest.approx(154.7e9, rel=1e-3)


# -- the forward -----------------------------------------------------------------------


@pytest.mark.parametrize("model", [TINY, TINY_LEAKY], ids=["relu", "leaky"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float32_forward_equals_the_reference(model, seed):
    """All 15 columns. Both run oneDNN's float32 convolutions on the same
    weights; the tolerance is float32 rounding over the network's ~70
    layers, reached through another summation order (the program's
    channels_last, the reference's NCHW)."""
    params, net, pool = tiny_case(model, seed)
    x = pool.float() / 255.0
    with torch.no_grad():
        got, want = net(x), ref.forward(params, x, model)
    assert got.shape == want.shape == (4, 168, 15)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# A column group's largest gap to the float32 reference, normalised units.
# Read at TINY over three seeds and both activations: the bf16 serving copy
# up to 0.038 (scores), 0.0034 (boxes), 0.0024 (points); the reference in
# float8 (the precision below the configuration's) 0.167, 0.023, 0.016 at
# least. Each limit sits about twice above the one and twice below the other.
BF16_LIMITS = {"score": (slice(0, 1), 0.08), "box": (slice(1, 5), 0.01),
               "points": (slice(5, 15), 0.008)}


@pytest.mark.parametrize("model", [TINY, TINY_LEAKY], ids=["relu", "leaky"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_serving_copy_within_bf16(model, seed):
    params, net, pool = tiny_case(model, seed)
    x = pool.float() / 255.0
    det = Detector(net, dtype=torch.bfloat16)
    with torch.no_grad():
        want = ref.forward(params, x, model)
        f8 = ref.forward(params, x, model, Precision("float8"))
    got = det.apply(x)
    for part, (cols, limit) in BF16_LIMITS.items():
        assert float((got[..., cols] - want[..., cols]).abs().max()) <= limit, part
        assert float((f8[..., cols] - want[..., cols]).abs().max()) > limit, part


@pytest.mark.parametrize("model", [TINY, {**FULL, "input_shape": [96, 96]}],
                         ids=["tiny", "full-width"])
def test_flop_counts_equal_the_counter(model):
    """The analytic count against ``FlopCounterMode`` over the program's
    float32 forward (the bf16 serving copy pads the narrow heads' GEMMs)."""
    net = build_model("retinaface", program.family({"family": "retinaface"}).model_config(
        {**CONFIG, "model": model}), "cpu", torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(torch.rand(2, *model["input_shape"], 3))
    assert counter.get_total_flops() / 2 == pytest.approx(ref.flop_counts(model)[0], rel=1e-12)


# -- K1's index and the predict path -------------------------------------------------------


def rows_and_tables(seed: int, b: int = 3, n: int = 400):
    gen = torch.Generator().manual_seed(seed)
    rows = torch.rand((b, n, 5), generator=gen)
    rows[..., 3:] = 0.02 + 0.3 * rows[..., 3:]
    return rows, knms.ssd_output_tables_on(n, (200, 160), torch.device("cpu"))


@pytest.mark.parametrize("capacity", [8, 500])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_index_is_greedy_order(seed, capacity):
    rows, tables = rows_and_tables(seed)
    boxes, mask, index = knms.decode_filter_nms_reference(rows, tables, 0.7, 0.3, capacity,
                                                          indexed=True)
    assert index.dtype == torch.int32 and index.shape == mask.shape
    for i in range(rows.shape[0]):
        scores, cands = ref.candidates(torch.cat([rows[i], torch.zeros(400, 10)], 1),
                                       {"input_shape": [160, 200]})
        kept = greedy_kept(scores, cands, 0.7, 0.3, capacity)
        k = len(kept)
        assert index[i, :k].tolist() == kept and bool((index[i, k:] == -1).all())
        assert int(mask[i].sum()) == k
        assert torch.equal(boxes[i, :k, 0], rows[i, kept, 0])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_existing_op_is_unchanged(seed):
    """The indexed op's boxes and mask are the op's, whose schema and two
    outputs stand as they were."""
    rows, tables = rows_and_tables(seed)
    cols = [torch.as_tensor(t) for t in tables[:4]]
    plain = knms.decode_filter_nms_op(rows, *cols, 200.0, 160.0, 0.7, 0.3, 64)
    indexed = knms.decode_filter_nms_indexed_op(rows, *cols, 200.0, 160.0, 0.7, 0.3, 64)
    assert len(plain) == 2 and len(indexed) == 3
    assert all(torch.equal(p, q) for p, q in zip(plain, indexed[:2]))
    assert all(torch.equal(p, q) for p, q in
               zip(plain, knms.decode_filter_nms_batch(rows, tables, 0.7, 0.3, 64)))
    assert str(torch.ops.fdtpu_torch.decode_filter_nms.default._schema) == (
        "fdtpu_torch::decode_filter_nms(Tensor values, Tensor sx, Tensor ox, Tensor sy, "
        "Tensor oy, float w_scale, float h_scale, float prob, float iou, int capacity) "
        "-> (Tensor, Tensor)")


def test_the_indexed_op_has_a_fake():
    rows, tables = rows_and_tables(1)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = mode.from_tensor(rows)
        cols = [mode.from_tensor(torch.as_tensor(t)) for t in tables[:4]]
        boxes, mask, index = knms.decode_filter_nms_indexed_op(fake, *cols, 200.0, 160.0, 0.7,
                                                               0.3, 64)
    assert (boxes.shape, mask.dtype, index.shape, index.dtype) == (
        (3, 64, 5), torch.bool, (3, 64), torch.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_against_the_reference(seed):
    """The float32 Detector on the CPU: the reference's greedy NMS of its
    candidates, boxes, mask and the kept rows' points (the reference's
    decode, in pixels) equal; the batch path on the same forward gives the
    same three."""
    params, net, pool = tiny_case(TINY, seed)
    det = Detector(net, 0.6, 0.4, 750, dtype=torch.float32)
    with torch.no_grad():
        rows = ref.forward(params, pool.float() / 255.0, TINY)
    kept_any = 0
    for frame, r in zip(pool.numpy(), rows):
        pred = det.predict(frame)
        norm, boxes, mask = pred
        points = pred.landmarks
        batch = det.non_max_suppression(det.apply(norm[None]))
        assert len(batch) == 3
        assert all(torch.equal(a[0], b) for a, b in zip(batch, (boxes, mask, points)))
        scores, cands = ref.candidates(r, TINY)
        kept = greedy_kept(scores, cands, 0.6, 0.4, 750)
        k = len(kept)
        kept_any += k
        assert mask.tolist() == [True] * k + [False] * (750 - k)
        torch.testing.assert_close(boxes[:k, 0], scores[kept])
        assert torch.equal(boxes[:k, 1:], cands[kept])
        torch.testing.assert_close(points[:k], ref.landmarks_px(r, TINY)[kept])
        assert bool((points[k:] == 0).all()) and bool((boxes[k:] == 0).all())
    assert kept_any > 0


def test_landmarks_need_a_landmark_family():
    """A family without landmarks answers as before: three outputs from
    ``predict`` with ``landmarks`` None, two from the batch path."""
    from fdtpu_torch.utils.config import DetectorConfig

    cfg = DetectorConfig(filters=8, input_shape=(160, 160), num_patches=5, num_residual_blocks=1)
    det = Detector(build_model("poolresnet", cfg, "cpu"), dtype=torch.float32)
    pred = det.predict(np.zeros((160, 160, 3), np.uint8))
    assert len(pred) == 3 and pred.landmarks is None
    assert len(det.non_max_suppression(det.apply(pred[0][None]))) == 2


# -- the scratch counter and its reader --------------------------------------------------------


def test_replay_counts_scratch_launches_while_traced():
    """A graph that holds K1 on its scratch path adds its launches to the
    counter ``nms_scratch`` when replayed under a profiler, and only
    then; each replay adds them to ``LAUNCHES`` too."""
    per = collections.Counter(decode_filter_nms=1, decode_filter_nms_scratch=1)
    g = graphs.Graph(types.SimpleNamespace(replay=lambda: None), (), (), per, 0, 0.0)
    start = LAUNCHES.copy()
    trace.clear()
    g.replay()
    assert trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        g.replay()
        g.replay()
    assert trace.counters() == {"nms_scratch": 2}
    assert LAUNCHES - start == collections.Counter(decode_filter_nms=3,
                                                   decode_filter_nms_scratch=3)
    trace.clear()


def test_nms_scratch_reader(monkeypatch):
    window = types.SimpleNamespace(busy_s=1.0, window_s=2.0,
                                   op_seconds=lambda *parts: (0.006, 4))
    ctx = {"mode": "stream", "units": 4, "window": window}
    read = reader("nms_scratch_ms.stream")
    monkeypatch.setattr(trace, "counters", lambda: {"nms_scratch": 4})
    assert read(ctx) == pytest.approx(1.5)
    assert read({**ctx, "mode": "train"}) is None
    monkeypatch.setattr(trace, "counters", lambda: {"nms_scratch": 3})  # not one a frame
    assert read(ctx) is None
    monkeypatch.setattr(trace, "counters", dict)  # a program without the counter
    assert read(ctx) is None


# -- entry points ---------------------------------------------------------------------------


def small_module():
    cfg = RetinaFaceConfig(input_shape=(64, 64), in_channels=(32, 64, 128), out_channel=72)
    return build_model("retinaface", cfg, "cpu")


@pytest.mark.parametrize("entry", ["train", "eval", "export"])
def test_training_and_export_refuse_it(entry):
    from fdtpu_torch.export import export_predict
    from fdtpu_torch.train import make_eval_step, make_train_step
    from fdtpu_torch.utils.config import TrainConfig

    module = small_module()
    calls = {"train": lambda: make_train_step(module, TrainConfig()),
             "eval": lambda: make_eval_step(module),
             "export": lambda: export_predict(module, "unused.pt2")}
    with pytest.raises(NotImplementedError, match="RetinaFace is served only"):
        calls[entry]()


@pytest.mark.parametrize("converter,error,match", [
    ("convert_checkpoint_to_exported_model", NotImplementedError, "RetinaFace is served only"),
    ("convert_checkpoint_to_native_model", ValueError, "no .fdn program for RetinaFace")])
def test_converters_refuse_it(converter, error, match, tmp_path):
    """The converters build RetinaFace from its own config and the export
    refuses it by name (no obscure failure in ``build_model``)."""
    import importlib

    mod = importlib.import_module(f"fdtpu_torch.{converter}")
    with pytest.raises(error, match=match):
        mod.main(["--model", "retinaface", "--input", "64", "--device", "cpu",
                  "--out", str(tmp_path / "model")])


@pytest.mark.parametrize("entry", ["profile_train", "run_validation_epoch", "train_model"])
def test_training_entry_points_refuse_it(entry, monkeypatch, capsys):
    import importlib

    mod = importlib.import_module(f"fdtpu_torch.{entry}")
    monkeypatch.setattr(sys, "argv", [entry, "--model", "retinaface"])
    with pytest.raises(SystemExit):
        mod.main() if entry == "profile_train" else mod.parse_args(["--model", "retinaface"])
    assert "retinaface" in capsys.readouterr().err


def test_demo_and_load_checkpoint_serve_it(tmp_path):
    from fdtpu_torch import demo_model, load_checkpoint
    from fdtpu_torch.data import make_synthetic_widerface

    demo_model.main(["--model", "retinaface", "--input", "64", "--device", "cpu",
                     "--images", str(tmp_path / "none"), "--out", str(tmp_path / "out")])
    assert len(list((tmp_path / "out").glob("*"))) == 3
    det = demo_model.build_detector(demo_model.parse_args(
        ["--model", "retinaface", "--input", "64", "--device", "cpu"]))
    assert (det.probability_threshold, det.iou_threshold, det.nms_capacity) == (0.6, 0.4, 750)
    make_synthetic_widerface(tmp_path / "data", 2, split="val", seed=1)
    gt, pred = load_checkpoint.main(["--data-dir", str(tmp_path / "data"), "--model", "retinaface",
                                     "--input", "64", "--device", "cpu"])
    assert pred.shape[1:] == (5,)


def test_build_model_takes_only_a_retinaface_config():
    """Another family's config would serve RetinaFace at its thresholds and
    capacity: refused, and ``serving_config`` makes the right one."""
    from fdtpu_torch.utils.config import DetectorConfig, serving_config

    with pytest.raises(TypeError, match="RetinaFaceConfig"):
        build_model("retinaface", DetectorConfig(input_shape=(64, 64)), "cpu")
    assert serving_config("retinaface", 64) == RetinaFaceConfig(input_shape=(64, 64))
    assert serving_config("ssd", 64, filters=8) == DetectorConfig(filters=8, input_shape=(64, 64))
