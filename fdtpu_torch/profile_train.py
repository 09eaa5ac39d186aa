"""Profile the port's train step on one CUDA card.

    python -m fdtpu_torch.profile_train [--batch 128] [--size 320] [--grid 15]
                                        [--no-rotate] [--fused-photometric]
                                        [--steps 10]
    python -m fdtpu_torch.profile_train --model ssd [--batch 24] [--size 480]
    python -m fdtpu_torch.profile_train --model mobilenetv3 [--batch 8] [--size 480]

Drives ``make_train_step`` at ``bench.py``'s train shape by default
(PoolResnet-128, 10 blocks, bf16 compute with float32 params, SAM + Adam,
device augmentation with positional crop and rotation; ``--fused-photometric``
takes the float32 route through the fused photometric kernel); with
``--model ssd`` at ``train_model_ssd``'s (SSD-16, 480 px, 4,774 priors,
b24, SAM + Adam, augmentation off); with ``--model resnet | separable |
mobilenetv3`` at ``train_model``'s shape for that family (b8, 480 px, grid
15, or 16 patches for SeparableCNN, device augmentation with rotation;
MobileNetV3 with its BatchNorm state); random weights and u8 frames from
seed 0, one face per image. Prints, beside the card's nvidia-smi name and power
limit:

* ms per step by CUDA events over ``--steps`` steps after warmup, with no
  profiler attached;
* under ``torch.profiler`` over ``--steps`` more steps: device busy time per
  step (the union of kernel intervals), the idle share against the
  unprofiled step time, kernels per step, host and device time of each
  phase of the step (the ``train/*`` spans of ``fdtpu_torch/train/step.py``;
  device time is the sum of the kernels launched inside the phase, those of
  the backward passes included), device time by kernel class, and the top
  kernels.

Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fdtpu_torch.models import FAMILIES, build_model, ssd_patch_sizes
from fdtpu_torch.train import create_train_state, make_train_step
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
          model: str = "poolresnet"):
    if model == "ssd":
        cfg = SSDConfig(input_shape=(size, size), patch_sizes=ssd_patch_sizes((size, size)))
    else:
        cfg = DetectorConfig(input_shape=(size, size), num_patches=grid)
    module = build_model(model, cfg, "cuda", torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=rotate, positional_crop=True,
                       fused_photometric=fused_photometric)
    state = create_train_state(module, tcfg, 100)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(batch, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((batch, 4, 5), dtype=np.float32)
    boxes[:, 0] = [1.0, 40, 60, 120, 100]
    masks = np.tile([True, False, False, False], (batch, 1))
    data = tuple(torch.from_numpy(a).cuda() for a in (images, boxes, masks))
    # the SSD trains without augmentation, as train_model_ssd does by default
    return state, make_train_step(module, tcfg, augment=model != "ssd"), data


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    ap.add_argument("--batch", type=int, default=None,
                    help="default 128 (24 for ssd, 8 for the rest of the zoo)")
    ap.add_argument("--size", type=int, default=None, help="default 320 (480 but poolresnet)")
    ap.add_argument("--grid", type=int, default=None, help="default 15 (16 for separable)")
    ap.add_argument("--no-rotate", action="store_true")
    ap.add_argument("--fused-photometric", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
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
    state, step, data = setup(args.batch, args.size, args.grid, not args.no_rotate,
                              args.fused_photometric, args.model)
    n = args.steps

    for _ in range(5):
        step(state, *data)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step(state, *data)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, *data)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("train/")]
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
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / n
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n

    if ssd:
        shape = (f"train SSD-16 b{args.batch} {args.size}px "
                 f"({sum(p * p for p in ssd_patch_sizes((args.size,) * 2))} priors) bf16 "
                 "SAM+Adam, augmentation off")
    else:
        shape = (f"train {args.model} b{args.batch} {args.size}px grid {args.grid} bf16 SAM+Adam, "
                 f"rotation "
                 f"{'off' if args.no_rotate else 'on'}, photometric "
                 f"{'fused (float32)' if args.fused_photometric else 'default chain (bfloat16)'}")
    print(f"== {shape} [{card}]")
    print(f"step {step_ms:.3f} ms by CUDA events, unprofiled ({args.batch * 1e3 / step_ms:.1f} "
          f"img/s); under the profiler {host_ms:.3f} ms by host clock")
    print(f"device busy {busy:.3f} ms/step (kernels summed {kernel_ms:.3f} ms), idle share "
          f"{1 - busy / step_ms:.3f} of the unprofiled step; {len(kernels) / n:.0f} kernels/step")
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


if __name__ == "__main__":
    main()
