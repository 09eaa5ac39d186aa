"""Benchmark of the port: ``bench.py``'s workload and JSON line, on one card.

    python -m fdtpu_torch.bench [--rotate-device] [--device cuda]

The workload is ``bench.py``'s: PoolResnet-128 at 320 px (grid 15), batch
128, bf16 compute with float32 params.

* **train**: the full default step (device augmentation with positional
  crop, rotation on the shear kernels only with ``--rotate-device`` ->
  target encode -> forward -> SAM two-point gradients -> Adam), one eager
  step a batch;
* **infer**: u8 frames on the card, ``/255``, the bf16 forward, decode +
  filter + NMS at capacity 64 (the K1 kernel), on the params after
  training; each iteration flips the frames' low bit when the detection
  count is odd (``bench.py``'s u8 XOR carry), so the iterations chain;
* **b1 latency**: one f32 320 px frame through the forward and the decode
  at capacity 64, chained the same way through a 1e-7 nudge.

Each loop is an eager Python loop of ``bench.py``'s length (100, 300 and
2,000 iterations), timed by CUDA events around the whole loop after
warmup; each metric is the median of ``REPS`` = 3 such loops, with min and
max. The infer and b1 rows launch K1 eagerly too (the Detector's eager
decode, not ``non_max_suppression``, which replays K1 from a CUDA graph on
a card).

``bench.py`` times each loop as one scanned device program, "so per-call
host dispatch doesn't pollute" the number. Beside the eager rows, which
keep their keys and meaning, the graph rows are that measurement on the
card: the train step captured in a CUDA graph
(``fdtpu_torch.train.graphs.CapturedTrainStep``) replayed 100 times back to
back (``train_graph_images_per_sec``), and the predict program
(``export.PredictProgram``: u8 frames, ``/255``, the bf16 forward, K1 at
0.5 / 0.5 / 64) through ``export.GraphPredict`` at b128
(``infer_graph_images_per_sec``, 300 replays) and b1
(``serving_latency_b1_graph_ms``, 2,000 replays of a u8 frame), each with
its min and max; each replay copies its input in and its outputs out. On
the CPU the graph rows are null. The loop lengths and reps are arguments of the measuring functions
(:func:`measure_train`, :func:`measure_infer`, :func:`measure_latency`,
:func:`run`), whose defaults are these values; the command line does not
expose them. On the CPU (``--device cpu``, for tests) the host clock times
the loops and no MFU is computed.

MFU divides analytic conv FLOPs (:func:`poolresnet_forward_flops`, a copy
of ``bench.py``'s) by the H100 SXM's dense bf16 peak, 989 TFLOP/s. The
``vs_baseline`` fields divide by ``bench.py``'s torch-CPU constants.

Prints ONE JSON line with ``bench.py``'s keys, plus ``card`` (nvidia-smi's
name and power limit), ``serving_latency_b1_ms_min_max``,
``rotate_device`` and the graph rows.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fdtpu_torch.bench_pool_fusion import card_line
from fdtpu_torch.export.export import GraphPredict, PredictProgram
from fdtpu_torch.models import Detector, build_model
from fdtpu_torch.train.graphs import CapturedTrainStep
from fdtpu_torch.train.state import create_train_state, make_optimizer
from fdtpu_torch.train.step import make_train_step
from fdtpu_torch.utils.config import DetectorConfig, TrainConfig

# bench.py:43-44: architecture-identical PyTorch on a CPU core
TORCH_CPU_TRAIN_IMG_S = 9.475911077684254
TORCH_CPU_INFER_IMG_S = 26.036849319826427

SIZE = 320
FILTERS = 128
BLOCKS = 10
BATCH = 128
GRID = 15
TRAIN_LOOP = 100
INFER_LOOP = 300
LATENCY_LOOP = 2000
REPS = 3
WARMUP = 3
CAPACITY = 64

# dense bf16 peak of one H100 SXM (NVIDIA data sheet); MFU readout only
PEAK_BF16_FLOPS = 989e12


def poolresnet_forward_flops(size: int, filters: int, blocks: int, num_patches: int = 15) -> float:
    """Analytic conv FLOPs (2*MACs) of one PoolResnet forward pass, a copy
    of ``bench.py``'s. Geometry per ``fdtpu_torch/models/poolresnet.py``:
    stem k10/s8/p2, ``blocks`` residual blocks of two 3x3 convs (pool after
    while dim > 2*num_patches), head k6 valid. 320px/128f/10blk/grid 15 ->
    3.2003 GFLOPs (fwd)."""
    dim = (size + 4 - 10) // 8 + 1  # stem output
    f = 2.0 * dim * dim * filters * 3 * 100
    for _ in range(blocks):
        f += 2 * (2.0 * dim * dim * filters * filters * 9)
        if dim > 2 * num_patches:
            dim //= 2
    out = dim - 5  # head k6, VALID
    f += 2.0 * out * out * 5 * filters * 36
    return f


def _timed(fn, iters: int, reps: int, device: torch.device) -> list[float]:
    """Seconds of ``iters`` calls of ``fn``, ``reps`` times, after the
    caller's warmup: CUDA events around the whole loop on a card (its
    results stay on the card), the host clock on the CPU."""
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append(time.perf_counter() - t0)
    return out


def make_workload(device: torch.device | str = "cuda", rotate_device: bool = False,
                  size: int = SIZE, batch: int = BATCH, filters: int = FILTERS,
                  blocks: int = BLOCKS, grid: int = GRID) -> dict:
    """``bench.py``'s model, train state, step and batch on ``device``:
    random u8 frames (numpy seed 0), one face an image, weights from seed
    0."""
    device = torch.device(device)
    cfg = DetectorConfig(filters=filters, input_shape=(size, size), num_patches=grid,
                         num_residual_blocks=blocks)
    module = build_model("poolresnet", cfg, device, torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16)
    # positional_crop: the Trainer resolves it True for shuffled feeds
    # (every training entry point shuffles), so bench the same path
    config = TrainConfig(use_sam=True, rotate_device=rotate_device, positional_crop=True)
    state = create_train_state(module, config, 100)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(batch, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((batch, 4, 5), dtype=np.float32)
    boxes[:, 0] = [1.0, 40, 60, 120, 100]
    box_mask = np.tile([True, False, False, False], (batch, 1))
    sample_mask = np.ones((batch,), dtype=bool)
    return {
        "device": device, "size": size, "batch": batch, "filters": filters, "blocks": blocks,
        "grid": grid, "rotate_device": rotate_device, "config": config, "state": state,
        "step": make_train_step(module, config, augment=True),
        "data": tuple(torch.from_numpy(a).to(device)
                      for a in (images, boxes, box_mask, sample_mask)),
    }


def measure_train(w: dict, iters: int = TRAIN_LOOP, reps: int = REPS) -> list[float]:
    """Train img/s of ``reps`` loops of ``iters`` steps (after ``WARMUP``
    steps); the losses of the timed steps must be finite."""
    losses = []

    def one():
        w["state"], scalars = w["step"](w["state"], *w["data"])
        losses.append(scalars["loss"])

    for _ in range(WARMUP):
        one()
    losses.clear()
    secs = _timed(one, iters, reps, w["device"])
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("non-finite loss in the timed train steps")
    return [w["batch"] * iters / s for s in secs]


def _detector(w: dict) -> Detector:
    """The serving Detector (bf16 copy) of the params after training."""
    return Detector(w["state"].module, probability_threshold=0.5, iou_threshold=0.5,
                    nms_capacity=CAPACITY)


def _eager_decode(det: Detector, output: torch.Tensor):
    """The Detector's decode+filter+NMS at its thresholds, K1 launched by
    its wrapper: the eager rows stay eager loops."""
    return det._decode(output, det.probability_threshold, det.iou_threshold, det.nms_capacity)


def measure_infer(w: dict, iters: int = INFER_LOOP, reps: int = REPS) -> list[float]:
    """Infer img/s on u8 frames: ``/255``, forward, decode at capacity 64,
    the frames' low bit flipped when the detection count is odd."""
    det = _detector(w)
    carry = [w["data"][0].clone()]

    def one():
        _, mask = _eager_decode(det, det.apply(carry[0].float() / 255.0))
        carry[0] = carry[0] ^ (mask.sum() % 2).to(torch.uint8)

    for _ in range(WARMUP):
        one()
    return [w["batch"] * iters / s for s in _timed(one, iters, reps, w["device"])]


def measure_latency(w: dict, iters: int = LATENCY_LOOP, reps: int = REPS) -> list[float]:
    """ms of one f32 frame through forward + decode at capacity 64, each
    iteration nudged by the last one's top score."""
    det = _detector(w)
    carry = [w["data"][0][:1].float() / 255.0]

    def one():
        boxes, _ = _eager_decode(det, det.apply(carry[0]))
        carry[0] = carry[0] + 1e-7 * boxes[:, 0, 0].sum()

    for _ in range(10 * WARMUP):
        one()
    return [1e3 * s / iters for s in _timed(one, iters, reps, w["device"])]


def measure_train_graph(w: dict, iters: int = TRAIN_LOOP, reps: int = REPS) -> list[float]:
    """:func:`measure_train` through the step captured in a CUDA graph
    (captured at its first call, kept as ``w["captured"]``), replayed back
    to back. The eager rows' Adam is plain, as the eager data-parallel step's
    is; the graph needs a capturable one, which starts here from the
    trained params with fresh moments."""
    state = w["state"]
    state.optimizer = make_optimizer(w["config"], state.module.parameters(), capturable=True)
    captured = w["captured"] = CapturedTrainStep(w["step"])
    losses = []

    def one():
        w["state"], scalars = captured(w["state"], *w["data"])
        losses.append(scalars["loss"])

    for _ in range(WARMUP):
        one()
    losses.clear()
    secs = _timed(one, iters, reps, w["device"])
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("non-finite loss in the timed graph replays")
    return [w["batch"] * iters / s for s in secs]


def _graph_predict(w: dict, frames: torch.Tensor) -> GraphPredict:
    """The predict program of the params after training (bf16, K1 at
    0.5 / 0.5 / 64), captured at ``frames``' shape."""
    program = PredictProgram(w["state"].module, 0.5, 0.5, CAPACITY, torch.bfloat16)
    return GraphPredict(program, frames, warmup=WARMUP)


def measure_infer_graph(w: dict, iters: int = INFER_LOOP, reps: int = REPS) -> list[float]:
    """Infer img/s of the b128 u8 frames through :class:`GraphPredict`."""
    graph = _graph_predict(w, w["data"][0])
    return [w["batch"] * iters / s
            for s in _timed(lambda: graph(w["data"][0]), iters, reps, w["device"])]


def measure_latency_graph(w: dict, iters: int = LATENCY_LOOP, reps: int = REPS) -> list[float]:
    """ms of one u8 frame through :class:`GraphPredict` at b1."""
    frame = w["data"][0][:1]
    graph = _graph_predict(w, frame)
    return [1e3 * s / iters for s in _timed(lambda: graph(frame), iters, reps, w["device"])]


def _median_range(values: list[float] | None):
    if values is None:
        return None, None
    return float(np.median(values)), [min(values), max(values)]


def run(device: torch.device | str = "cuda", rotate_device: bool = False,
        train_iters: int = TRAIN_LOOP, infer_iters: int = INFER_LOOP,
        latency_iters: int = LATENCY_LOOP, reps: int = REPS, **shape) -> dict:
    """The three measurements and ``bench.py``'s result line. ``shape``
    (``size``, ``batch``, ``filters``, ``blocks``, ``grid``) shrinks the
    workload for tests."""
    w = make_workload(device, rotate_device, **shape)
    train = measure_train(w, train_iters, reps)
    infer = measure_infer(w, infer_iters, reps)
    latency = measure_latency(w, latency_iters, reps)
    dev = w["device"]
    on_card = dev.type == "cuda"
    graph_train = measure_train_graph(w, train_iters, reps) if on_card else None
    graph_infer = measure_infer_graph(w, infer_iters, reps) if on_card else None
    graph_latency = measure_latency_graph(w, latency_iters, reps) if on_card else None
    graph_train_img_s, graph_train_range = _median_range(graph_train)
    graph_infer_img_s, graph_infer_range = _median_range(graph_infer)
    graph_latency_ms, graph_latency_range = _median_range(graph_latency)
    train_img_s, infer_img_s = float(np.median(train)), float(np.median(infer))
    fwd = poolresnet_forward_flops(w["size"], w["filters"], w["blocks"], w["grid"])
    # SAM step = 2 points x (forward + backward); backward ~ 2x forward
    train_per_img = 6.0 * fwd
    return {
        "metric": "train_images_per_sec_per_chip_320px",
        "value": train_img_s,
        "unit": "images/sec",
        "vs_baseline": train_img_s / TORCH_CPU_TRAIN_IMG_S,
        "infer_images_per_sec": infer_img_s,
        "infer_vs_baseline": infer_img_s / TORCH_CPU_INFER_IMG_S,
        "train_img_s_min_max": [min(train), max(train)],
        "infer_img_s_min_max": [min(infer), max(infer)],
        "serving_latency_b1_ms": float(np.median(latency)),
        "serving_latency_b1_ms_min_max": [min(latency), max(latency)],
        "reps": reps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_line() if on_card else None,
        "model": f"PoolResnet-{w['filters']} {w['size']}px b{w['batch']} bf16 sam+aug",
        "rotate_device": rotate_device,
        "fwd_gflops_per_img": fwd / 1e9,
        # a CPU run measures no card: no MFU
        "train_mfu": train_img_s * train_per_img / PEAK_BF16_FLOPS if on_card else None,
        "infer_mfu": infer_img_s * fwd / PEAK_BF16_FLOPS if on_card else None,
        # the graph rows: bench.py's scanned loops on the card (null on the CPU)
        "train_graph_images_per_sec": graph_train_img_s,
        "train_graph_img_s_min_max": graph_train_range,
        "infer_graph_images_per_sec": graph_infer_img_s,
        "infer_graph_img_s_min_max": graph_infer_range,
        "serving_latency_b1_graph_ms": graph_latency_ms,
        "serving_latency_b1_graph_ms_min_max": graph_latency_range,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rotate-device", action="store_true",
                    help="include the on-device Rotate pass (the shear kernels) in the "
                         "train step")
    ap.add_argument("--device", default="cuda", help="torch device: cuda, or cpu for tests")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.rotate_device)))


if __name__ == "__main__":
    main()
