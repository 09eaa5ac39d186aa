"""Profile the port's train step on one CUDA card.

    python -m fdtpu_torch.profile_train [--batch 128] [--size 320] [--grid 15]
                                        [--no-rotate] [--fused-photometric]
                                        [--steps 10]
    python -m fdtpu_torch.profile_train --model ssd [--batch 24] [--size 480]
    python -m fdtpu_torch.profile_train --model mobilenetv3 [--batch 8] [--size 480]
    python -m fdtpu_torch.profile_train --data-parallel [...]
    python -m fdtpu_torch.profile_train --graph [--data-parallel] [...]

Drives ``make_train_step`` at ``bench.py``'s train shape by default
(PoolResnet-128, 10 blocks, bf16 compute with float32 params, SAM + Adam,
device augmentation with positional crop and rotation; ``--fused-photometric``
takes the float32 route through the fused photometric kernel); with
``--model ssd`` at ``train_model_ssd``'s (SSD-16, 480 px, 4,774 priors,
b24, SAM + Adam, augmentation off); with ``--model resnet | separable |
mobilenetv3`` at ``train_model``'s shape for that family (b8, 480 px, grid
15, or 16 patches for SeparableCNN, device augmentation with rotation;
MobileNetV3 with its BatchNorm state); random weights and u8 frames from
seed 0, one face per image. ``--data-parallel`` profiles the data-parallel
step instead (``make_dp_train_step`` in a one-rank NCCL group): the same
step plus its reductions, what data parallelism costs a step on one card.
Prints, beside the card's nvidia-smi name and power limit:

* ms per step by CUDA events over ``--steps`` steps after warmup, with no
  profiler attached;
* under ``torch.profiler`` over ``--steps`` more steps: device busy time per
  step (the union of kernel intervals), the idle share of that profiled
  window (its length by CUDA events; the profiler lengthens it) and of the
  unprofiled step (two runs, so it can read below 0), kernels per step, host and device time of each
  phase of the step (the ``train/*`` spans of ``fdtpu_torch/train/step.py``;
  device time is the sum of the kernels launched inside the phase, those of
  the backward passes included), device time by kernel class, and the top
  kernels.

``--graph`` adds the graph arm after the eager one: the same step captured
in a CUDA graph (``fdtpu_torch.train.graphs.CapturedTrainStep``) and
replayed, with its step ms by CUDA events, device busy ms and idle share,
and the host's CUDA launch calls a step (kernel launches, graph launches,
copies and fills) beside the kernels a replay runs on the card. A replay
runs no phase span (its host code ran at the capture), so the graph arm has
no phase breakdown: the step is one ``fdtpu/train/step`` span. It also prints the graph's private pool
bytes and the seconds its warm-up and capture took. The graph needs a
capturable Adam (``train/state.py``), which ``--graph`` builds for both
arms, so that they run the same arithmetic; without it the eager arm's Adam
is plain. ``--data-parallel --graph`` times the data-parallel step in the
one-rank NCCL group eager against replayed, its two all-reduces a SAM step
captured in the graph.

Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fdtpu_torch.models import FAMILIES, SERVED_ONLY, build_model, ssd_patch_sizes
from fdtpu_torch.parallel import initialize_multihost, make_dp_train_step, shutdown
from fdtpu_torch.train import CapturedTrainStep, create_train_state, make_train_step
from fdtpu_torch.utils.config import DetectorConfig, SSDConfig, TrainConfig

# kernel classes, the first match on the lower-cased kernel name wins
CLASSES = (
    ("rotation (shear kernels)", ("shear_",)),
    ("photometric kernel", ("photometric_kernel",)),
    ("decode+NMS kernel", ("decode_filter_nms",)),
    ("convolution (cuDNN, CUTLASS, depthwise)", ("conv", "gemm", "xmma", "cutlass", "cudnn")),
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("reduction", ("reduce",)),
    ("copy, cast, fill", ("copy", "memcpy", "memset", "fill")),
    ("gather, scatter, index", ("index", "gather", "scatter")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def setup(batch: int, size: int, grid: int, rotate: bool, fused_photometric: bool = False,
          model: str = "poolresnet", data_parallel: bool = False, capturable: bool = False):
    if model == "ssd":
        cfg = SSDConfig(input_shape=(size, size), patch_sizes=ssd_patch_sizes((size, size)))
    else:
        cfg = DetectorConfig(input_shape=(size, size), num_patches=grid)
    module = build_model(model, cfg, "cuda", torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=rotate, positional_crop=True,
                       fused_photometric=fused_photometric)
    state = create_train_state(module, tcfg, 100, capturable=capturable)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(batch, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((batch, 4, 5), dtype=np.float32)
    boxes[:, 0] = [1.0, 40, 60, 120, 100]
    masks = np.tile([True, False, False, False], (batch, 1))
    data = tuple(torch.from_numpy(a).cuda() for a in (images, boxes, masks))
    # the SSD trains without augmentation, as train_model_ssd does by default
    make = make_dp_train_step if data_parallel else make_train_step
    return state, make(module, tcfg, augment=model != "ssd"), data


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    ap.add_argument("--batch", type=int, default=None,
                    help="default 128 (24 for ssd, 8 for the rest of the zoo)")
    ap.add_argument("--size", type=int, default=None, help="default 320 (480 but poolresnet)")
    ap.add_argument("--grid", type=int, default=None, help="default 15 (16 for separable)")
    ap.add_argument("--no-rotate", action="store_true")
    ap.add_argument("--fused-photometric", action="store_true")
    ap.add_argument("--data-parallel", action="store_true",
                    help="the data-parallel step, in a one-rank NCCL group")
    ap.add_argument("--graph", action="store_true",
                    help="add the arm of the step captured in a CUDA graph")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if args.model in SERVED_ONLY:
        ap.error(f"--model {args.model}: the port serves it and does not train it")
    ssd = args.model == "ssd"
    zoo = args.model not in ("poolresnet", "ssd")
    args.batch = args.batch or (24 if ssd else 8 if zoo else 128)
    args.size = args.size or (320 if args.model == "poolresnet" else 480)
    args.grid = args.grid or (16 if args.model == "separable" else 15)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rendezvous = tempfile.mkdtemp(prefix="fdtpu_profile_")
    try:
        if args.data_parallel:
            initialize_multihost(rank=0, world_size=1, device="cuda:0",
                                 init_method=f"file://{rendezvous}/store")
        profile_step(args, card, ssd)
    finally:
        shutdown()
        shutil.rmtree(rendezvous, ignore_errors=True)


# the host's CUDA runtime and driver calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def measure(run, n: int) -> dict:
    """``run()`` (one train step) timed ``n`` times by CUDA events with no
    profiler attached, after 5 warm-up calls, then ``n`` times under
    ``torch.profiler``: ``step_ms``, ``host_ms`` (profiled, by host
    clock), ``window_ms`` (profiled, by CUDA events around the same
    steps), ``busy_ms`` (the union of kernel intervals a step),
    ``kernel_ms`` (their sum), ``idle`` (1 - busy / window: one window, so
    it cannot read below 0, but the profiler lengthens it: its host cost
    an eager step's, its tracing of each kernel a replay's by ~0.5 µs a
    kernel), ``idle_unprofiled`` (1 - busy / step: free of the profiler's
    cost, but two runs, so it can read below 0), ``kernels`` and
    ``launch_calls`` a step, and the profiler's ``events``."""
    for _ in range(5):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    window_ms = start.elapsed_time(end) / n
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("train/")]
    calls = [e for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / n
    return {"step_ms": step_ms, "host_ms": host_ms, "window_ms": window_ms, "busy_ms": busy,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n,
            "idle": 1 - busy / window_ms, "idle_unprofiled": 1 - busy / step_ms,
            "kernels": len(kernels) / n,
            "launch_calls": len(calls) / n, "events": events, "kernel_events": kernels}


def profile_step(args, card: str, ssd: bool) -> None:
    state, step, data = setup(args.batch, args.size, args.grid, not args.no_rotate,
                              args.fused_photometric, args.model, args.data_parallel,
                              capturable=args.graph)
    n = args.steps
    eager = measure(lambda: step(state, *data), n)
    step_ms, host_ms, busy = eager["step_ms"], eager["host_ms"], eager["busy_ms"]
    kernel_ms, kernels, events = eager["kernel_ms"], eager["kernel_events"], eager["events"]
    spans = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("train/")]
    phases = defaultdict(lambda: [0.0, 0.0])
    for e in spans:
        phases[e.name][0] += e.cpu_time_total / 1e3 / n
        phases[e.name][1] += e.device_time_total / 1e3 / n
    # the backward passes run on autograd's own thread, under no span: each
    # top-level op there is charged to the span whose host window holds its
    # start
    for e in events:
        if (e.device_type == DeviceType.CPU and e.cpu_parent is None
                and not e.name.startswith("train/")):
            for s in spans:
                if s.time_range.start <= e.time_range.start <= s.time_range.end:
                    phases[s.name][1] += e.device_time_total / 1e3 / n
                    break

    if ssd:
        shape = (f"train SSD-16 b{args.batch} {args.size}px "
                 f"({sum(p * p for p in ssd_patch_sizes((args.size,) * 2))} priors) bf16 "
                 "SAM+Adam, augmentation off")
    else:
        shape = (f"train {args.model} b{args.batch} {args.size}px grid {args.grid} bf16 SAM+Adam, "
                 f"rotation "
                 f"{'off' if args.no_rotate else 'on'}, photometric "
                 f"{'fused (float32)' if args.fused_photometric else 'default chain (bfloat16)'}")
    if args.data_parallel:
        shape += ", the data-parallel step (NCCL, world size 1)"
    print(f"== {shape} [{card}]")
    print(f"step {step_ms:.3f} ms by CUDA events, unprofiled ({args.batch * 1e3 / step_ms:.1f} "
          f"img/s); under the profiler {host_ms:.3f} ms by host clock")
    print(f"device busy {busy:.3f} ms/step (kernels summed {kernel_ms:.3f} ms), idle share "
          f"{eager['idle']:.3f} of the profiled window ({eager['window_ms']:.3f} ms/step by CUDA "
          f"events), {eager['idle_unprofiled']:.3f} of the unprofiled step; "
          f"{len(kernels) / n:.0f} kernels/step, {eager['launch_calls']:.0f} host launch calls/step")
    for name, (host, dev) in sorted(phases.items(), key=lambda kv: -kv[1][1]):
        print(f"  phase {name}: host {host:.3f} ms, device {dev:.3f} ms")
    print(f"  outside every phase: device {kernel_ms - sum(d for _, d in phases.values()):.3f} ms")
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[kernel_class(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  class {label}: {us / 1e3 / n:.3f} ms/step ({us / 1e3 / n / kernel_ms:.1%})")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  kernel {us / 1e3 / n:7.3f} ms/step x {count / n:5.1f}  {name[:110]}")
    if args.graph:
        graph_arm(state, step, data, n, args.batch)


def graph_arm(state, step, data, n: int, batch: int) -> dict:
    """The step captured in a CUDA graph and replayed (``--graph``); prints
    and returns :func:`measure`'s numbers with the graph's."""
    captured = CapturedTrainStep(step)
    sample_mask = torch.ones(data[0].shape[:1], dtype=torch.bool, device=data[0].device)
    got = measure(lambda: captured(state, *data, sample_mask), n)
    (g,) = captured.graphs.values()
    print(f"graph arm: step {got['step_ms']:.3f} ms by CUDA events ({batch * 1e3 / got['step_ms']:.1f} "
          f"img/s); device busy {got['busy_ms']:.3f} ms/step, idle share {got['idle']:.3f} of the "
          f"profiled window ({got['window_ms']:.3f} ms/step), {got['idle_unprofiled']:.3f} of the "
          f"unprofiled step; "
          f"{got['kernels']:.0f} kernels a replay on the card, {got['launch_calls']:.0f} host "
          f"launch calls a step; graph pool {g.pool_bytes / 2**20:.1f} MiB, warm-up + capture "
          f"{g.capture_s:.2f} s; kernel launches a replay {g.per_replay}")
    return {**{k: v for k, v in got.items() if k not in ("events", "kernel_events")},
            "pool_bytes": g.pool_bytes, "capture_s": g.capture_s, "per_replay": g.per_replay}


if __name__ == "__main__":
    main()
