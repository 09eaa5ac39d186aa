"""On a card (``gpu``; skipped without one): ``Detector.predict``,
``non_max_suppression`` and the eval step replayed from their CUDA graphs
equal their eager bodies bit for bit, and the bf16 PoolResnet-128 predict
graph at 480 px runs its stem and head as GEMMs (``layers.narrow_conv``),
which no SSD predict graph and no train step graph does. No jax here, so
the file runs on a machine without it: ``python -m pytest --noconftest
tests/test_torch_serve_graphs_card.py``. ``chip_smoke.py`` phase 22 runs
the full sweep at full width, phase 23 times the narrow convolutions."""

from collections import Counter

import numpy as np
import pytest
import torch

from fdtpu_torch.models import Detector, PoolResnet, build_model
from fdtpu_torch.train import (CapturedEvalStep, CapturedTrainStep, create_train_state,
                               make_eval_step, make_train_step)
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.utils.config import DetectorConfig, SSDConfig, TrainConfig

SIZE = (160, 160)
THRESHOLDS = ((0.5, 0.5), (0.7, 0.01))


def frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(*SIZE, 3), dtype=np.uint8),
            rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8),
            rng.uniform(0, 255, size=(*SIZE, 3)).astype(np.float32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_predict_and_nms_replay_equal_eager(card):
    torch.manual_seed(0)
    det = Detector(PoolResnet(16, SIZE, 5, 2).to(card), nms_capacity=32)
    assert len(det._graphs) == 0
    for _ in range(2):
        for image in frames():
            for prob, iou in THRESHOLDS:
                got = det.predict(image, prob, iou)
                with torch.inference_mode():
                    img = torch.tensor(det.host_frame(image), device=card)
                    want = det.predict_body(img, prob, iou)
                for g, w in zip(got, want):
                    assert torch.equal(g, w[0])
    assert len(det._graphs) == 4  # (u8, float32) x two threshold pairs
    assert sum(g.replays for g in det._graphs.graphs.values()) == 12
    for b in (1, 8):
        out = det.apply(torch.rand((b, *SIZE, 3), device=card))
        got = det.non_max_suppression(out)
        want = det._decode(out, det.probability_threshold, det.iou_threshold, det.nms_capacity)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_graph_keeps_the_launches_of_its_warm_up(card):
    """A capture's warm-up runs the body twice (``capture_body``'s
    default) and the graph keeps those launches (``Graph.warm_launches``);
    the first ``predict`` adds them and one replay's to ``LAUNCHES``."""
    torch.manual_seed(0)
    det = Detector(PoolResnet(16, SIZE, 5, 2).to(card), nms_capacity=32)
    start = LAUNCHES.copy()
    det.predict(frames()[0])
    (g,) = det._graphs.graphs.values()
    assert g.per_replay["decode_filter_nms"] == 1
    assert g.warm_launches == Counter({k: 2 * n for k, n in g.per_replay.items()})
    assert LAUNCHES - start == g.warm_launches + g.per_replay


@pytest.mark.gpu
def test_eval_step_replay_equals_eager(card):
    torch.manual_seed(0)
    module = PoolResnet(16, SIZE, 5, 2).to(card)
    state = create_train_state(module, TrainConfig(), capturable=True)
    step = make_eval_step(module, nms_params=(0.05, 0.5, 64), return_boxes=True)
    captured = CapturedEvalStep(step)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (4, *SIZE, 3), dtype=np.uint8)).to(card)
    boxes = torch.tensor([[[1.0, 10, 20, 40, 50]] * 4] * 4, device=card)
    mask = torch.tensor([[True, False, False, False]] * 4, device=card)
    sample = torch.tensor([True, True, True, False], device=card)
    for form in ("batch", "gather"):
        ws, (wb, wm) = step(state, images, boxes, mask, sample)
        if form == "batch":
            gs, (gb, gm) = captured(state, images, boxes, mask, sample)
        else:
            gs, (gb, gm) = captured.gather(state, (images, boxes, mask, sample),
                                           torch.arange(4, device=card))
        assert all(torch.equal(ws[k], gs[k]) for k in ws)
        assert torch.equal(wb, gb) and torch.equal(wm, gm)
    assert captured.replays == 2


@pytest.mark.gpu
def test_threads_share_one_detector(card):
    """More threads than cores predict on one Detector, two threshold pairs
    in turn, the switch interval shortened: every result is its frame's
    eager body, so no call read another's static buffers."""
    import concurrent.futures
    import os
    import sys

    torch.manual_seed(0)
    det = Detector(PoolResnet(16, SIZE, 5, 2).to(card), nms_capacity=32)
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, size=(*SIZE, 3), dtype=np.uint8) for _ in range(16)]
    with torch.inference_mode():
        want = [[det.predict_body(torch.tensor(im, device=card), p, i) for p, i in THRESHOLDS]
                for im in images]

    def run(k):
        prob, iou = THRESHOLDS[k % 2]
        return k, det.predict(images[k % len(images)], prob, iou)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = 2 * (os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            results = [f.result(timeout=120) for f in [pool.submit(run, k) for k in range(256)]]
    finally:
        sys.setswitchinterval(interval)
    for k, got in results:
        w = want[k % len(images)][k % 2]
        assert all(torch.equal(g, x[0]) for g, x in zip(got, w)), k
    assert len(results) == 256


def replay_kernel_names(det, frame, prob) -> set:
    """The names of the kernels the card ran for one ``predict``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det.predict(frame, prob)
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.gpu
def test_poolresnet_predict_graph_runs_its_narrow_convs_as_gemms(card):
    """The config of record's bf16 Detector (PoolResnet-128, 480 px, grid
    10): the predict graph captured the stem's and the head's GEMMs
    (``conv_gemm``, 2 a replay, ``LAUNCHES`` up by 2 a frame), its replay
    runs no cuDNN ``precomputed_convolve`` kernel, equals the eager body
    bit for bit, and reads the serving copy's params as they are at the
    replay."""
    det = Detector(build_model("poolresnet", DetectorConfig(), card,
                               torch.Generator().manual_seed(0)))
    frame = np.random.default_rng(3).integers(0, 256, size=(480, 480, 3), dtype=np.uint8)
    prob = 0.01  # boxes carry the scores of many candidates

    def eager():
        with torch.inference_mode():
            return det.predict_body(torch.tensor(frame, device=card), prob, det.iou_threshold)

    first = det.predict(frame, prob)
    (g,) = det._graphs.graphs.values()
    assert g.per_replay["conv_gemm"] == 2
    start = LAUNCHES["conv_gemm"]
    names = replay_kernel_names(det, frame, prob)
    assert LAUNCHES["conv_gemm"] - start == 2
    assert names and not [n for n in names if "precomputed_convolve" in n]
    assert all(torch.equal(a, w[0]) for a, w in zip(first, eager()))
    with torch.no_grad():
        det.net.conv1.weight.mul_(0.5)
        det.net.out.bias.add_(0.25)
    changed = det.predict(frame, prob)
    assert all(torch.equal(a, w[0]) for a, w in zip(changed, eager()))
    assert not torch.equal(changed[1], first[1])
    assert len(det._graphs) == 1


@pytest.mark.gpu
def test_ssd_predict_and_train_step_graphs_run_no_gemm_form(card):
    """The cells' other graphs keep cuDNN: the bf16 SSD-16 predict graph at
    480 px (the SSD has its own stem) and the train steps replayed at
    PoolResnet-128 b8/480 and SSD-16 b24/480 (grad on)."""
    gen = torch.Generator().manual_seed(0)
    ssd_det = Detector(build_model("ssd", SSDConfig(), card, gen))
    ssd_det.predict(np.zeros((480, 480, 3), dtype=np.uint8))
    assert [g.per_replay["conv_gemm"] for g in ssd_det._graphs.graphs.values()] == [0]
    rng = np.random.default_rng(4)
    for family, cfg, b, tcfg in (
            ("poolresnet", DetectorConfig(), 8, TrainConfig(rotate_device=True,
                                                              positional_crop=True)),
            ("ssd", SSDConfig(), 24, TrainConfig())):
        module = build_model(family, cfg, card, torch.Generator().manual_seed(0),
                             compute_dtype=torch.bfloat16)
        state = create_train_state(module, tcfg, 100, capturable=True)
        captured = CapturedTrainStep(make_train_step(module, tcfg))
        images = torch.from_numpy(rng.integers(0, 256, (b, 480, 480, 3), dtype=np.uint8))
        boxes = torch.tensor([[[1.0, 100, 120, 80, 90]] * 4] * b)
        mask = torch.tensor([[True, False, False, False]] * b)
        start = LAUNCHES["conv_gemm"]
        captured(state, images.to(card), boxes.to(card), mask.to(card))
        (g,) = captured.graphs.values()
        assert g.per_replay["conv_gemm"] == 0, family
        assert LAUNCHES["conv_gemm"] == start, family
