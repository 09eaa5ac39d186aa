"""Smoke test of the PyTorch + CUDA port (fdtpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

(``python3 chip_smoke.py --kernel-times`` runs phases 1 and 2 and the K1-K4
timings alone, without plain versions, and prints them as one JSON line;
``python -m fdtpu_torch.compare_parent`` runs it in turns on two trees.)

Phases, one printed line each (any failure raises, and the script exits
non-zero; without a CUDA card it fails at once and prints no result):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written kernels from the checkout's sources;
3. the decode+filter+NMS kernel against its plain PyTorch version on the
   card: B in {1, 8, 128}, N in {100, 225, 4774}, capacity in {64, 128},
   thresholds 0.5/0.5 and 0.7/0.01, random, saturated, tie, all-equal and
   empty maps; negative scores under a threshold of -0.7 (a score <= -0.5
   ends the scan); +0.0 and -0.0 tied under -0.3; exactly capacity,
   capacity + 1, 256 and 257 eligible candidates (the rank sort's limit
   and the bitonic sort's first size); and past the kernel's shared-memory
   limit (its global-scratch path): N = the limit + 1 (8,187 on the H100),
   8,204 (SSD at 632 px) and 20,000, B in {1, 8}, capacity 128, random,
   saturated and tie maps. Outputs are allocated over blocks filled with
   0xFF, so a row the kernel fails to write shows. Masks, scores and
   coordinates must be bit-equal;
4. the full-width float32 forward (PoolResnet-128, 10 blocks, 480 px, B=2,
   TF32 off) on the card against the same model on the CPU, atol 1e-4;
5. the serving path: a bfloat16 Detector on the card, ``predict`` on three
   odd-sized u8 frames at DetectorConfig() (480 px, grid 10), then the batch
   path at the bench shape (320 px, grid 15, B=128, capacity 64). The
   kernel's launch count must rise once per call, and the batch path's boxes
   must equal the plain version's on the same forward output;
6. timings: the NMS kernel on the card alone (``device_ms``) through its
   wrapper and through the bare entry point, against its plain version,
   and its wrapper's host time a call (``host_us``), at three shapes, and
   its global-scratch path at (1, 8204), (8, 8204) and (8, 20000); with
   CUDA events after warmup the b128 forward + decode and the b1 predict
   latency;
7. the rotation kernels (shear_rows, shear_cols) against their plain
   versions on the card, every pass and the whole rotate_batch, float32 and
   bfloat16, B in {1, 8, 26}, S in {200, 320, 480} (200 = 8 mod 16), angles
   0, +-ROTATE_LIMIT_RAD and random; and K4's rotate_batch_transposed. Then
   the edges of both shears: k from 0 to 40 (shear_cols' ring, and its
   read straight from device memory when the shear outgrows the ring),
   rows not a multiple of its 128-row band (328, 37), lanes off the
   16-byte grid (45), c = 1, planes one element into their storage.
   Bit-equal;
8. one float32 SAM + SGD train step at DetectorConfig() (480 px, grid 10,
   B=2, augmentation and dropout off, TF32 off) on the card against the
   same step on the CPU: loss rtol 1e-4, grad norm rtol 1e-3, and the
   update (params after minus before) in relative L2 norm, 1e-2 over all
   params and 5e-2 for each tensor. The update is held in norm, not
   element by element: a pre-activation or max-pool pair that rounds to the
   other side of a leaky-ReLU or max-pool kink moves a few elements far,
   and which ones flip depends on the CPU's oneDNN kernels as much as on
   the card (oneDNN limited to AVX2 moves the update by 1.6e-3 in norm,
   1.2e-2 in one tensor, and 5.3e-5 in one element, against the same
   CPU with AVX-512). A wrong gradient in any tensor is off by order 1;
9. the training path: bf16 compute, float32 params, SAM + Adam, device
   augmentation with rotation, dropout on; five steps at the bench shape
   (PoolResnet-128, 10 blocks, 320 px, grid 15, B=128, positional crop) and
   five at DetectorConfig() with B=8, the last of each with train metrics.
   Losses finite, params moving; the shear launch counts rise by 3 per
   rotate_batch (one per step) and the NMS kernel launches once per metrics
   step;
10. timings with CUDA events after warmup: train img/s at b128/320 with
    rotation on and off, the b8/480 step; then each shear kernel on the
    card alone (``device_ms``) against its plain version at the shapes the
    training path gives it (and shear_rows on K4's channel-stacked planes
    of the same images), and against the library call, one
    ``F.grid_sample`` of the same planes (float32 only: with bfloat16
    planes its grid is bfloat16 too, which is not the same function), with
    its largest difference from the plain version;
11. the fused photometric kernel (K5) against its plain version on the
    card: identity, brightness/contrast, noise (seeds 0, 2^31 - 2 and
    random), glass, motion, all gates at once, at B in {1, 26, 128} and S in
    {64, 320, 480}; halo-free and blurred images in one batch, all noised,
    at 320 px and at odd sides (37x45, 33x70) that put rows, images and the
    buffer's end off the 16-byte grid; a view at an odd offset; each of the
    16 motion bins. Bit-equal with noise off; with noise on, bit-equal or
    within atol 1e-6 (the line says which). Then the whole fused exact-k
    augmentation at b128/320 with rotation, kernel against plain version on
    the same draws;
12. the fused residual-tail kernel (K6) against its plain version, float32
    and bfloat16, pooled and unpooled, channels_last and contiguous, with
    and without conv2's bias folded in, at (128, 128, 40, 40),
    (128, 128, 20, 20), (1, 128, 60, 60), (1, 128, 30, 30) and the edges:
    C = 12 and 6 (not a multiple of 8), (3, 5, 7, 9) (a numel not a
    multiple of 8), inputs at an offset of one element. Bit-equal. Then the
    K6 path: ``Detector.apply`` with ``fused_tail`` at b128/320 and b1/480,
    bit-equal to the eager forward, the tail kernel launched once a block;
13. the K5 path: three bf16 train steps at b128/320 with rotation and
    ``fused_photometric``, losses finite, the photometric kernel launched
    once a step; then timings with CUDA events after warmup: K5 against its
    plain version at b128/320 on four tables (the fused route's, every gate
    off, noise on every row, both blurs on every row), K6 at the eval
    forward's shapes with and without the bias, each with warm and cold L2
    (cycling through more than 150 MB of inputs), the train step with
    ``fused_photometric`` against the default chain, and the three arms of
    ``fdtpu_torch.bench_pool_fusion`` at b128/320 and b1/480;
14. the Trainer path at full width (``DetectorConfig()``, ``TrainConfig()``
    defaults with rotation on the card and no first-batch drawings), b8,
    SAM + Adam, on ``make_synthetic_widerface`` data (48 train, 16 val
    images) in a temporary directory: ``Trainer.fit`` for two epochs with
    ``StreamedDriver`` (losses finite, params moving, the ``.log``,
    ``.jsonl`` and TensorBoard records and a checkpoint each epoch written,
    K1 launched once a train epoch and once a val batch, the shears twice
    and once a rotating step); a resume in a new Trainer (params, Adam
    moments and step bit-equal to the saved ones) and one epoch more;
    ``ResidentDriver`` against ``StreamedDriver`` in float32 with shuffle and
    augmentation off and ``torch.use_deterministic_algorithms(True)``
    (epoch metrics and params bit-equal); ``run_validation_epoch --with-ap``
    on the saved checkpoint; and ``fdtpu_torch.bench``'s measuring
    functions with loops of 5, 20 and 50 and one rep (``bench.py``'s keys,
    every value finite);
15. the SSD path (SSD-16, ``train_model_ssd``'s model, random weights):
    the float32 forward at 480 px, B=2, card against CPU, atol 1e-4; bf16
    serving: ``predict`` on three odd-sized frames, then the batch path at
    b24/480 (N = 4,774, capacity 128, K1 in shared memory) and at b8/640
    (N = 8,500, K1 on global scratch), boxes bit-equal to the plain
    version's on the same forward output and K1 launched once a call; one
    float32 SAM + SGD step at 480 px, B=2, card against CPU, at phase 8's
    tolerances (the loss's hard-negative mining adds one more kink: a
    negative whose score ties within rounding may be mined on one device
    and not the other; the line counts those); five bf16 SAM + Adam steps
    at b24/480, augmentation off, the last with train metrics (K1 once);
    ``train_model_ssd``'s Trainer for two quarter-epochs on 192 / 24
    synthetic images, a resume (params, Adam moments and step bit-equal)
    and ``run_validation_epoch --model ssd --with-ap`` on its checkpoint;
    timings with CUDA events: the train step, forward + decode at b24 and
    the b1 ``predict``, and K1 alone on the SSD's maps at (24, 4774),
    (1, 4774) and (8, 8500), each with its plain version and bound.

16. the rest of the zoo at 480 px: MobileNetV3-Small (grid 15), Resnet-64
    (10 blocks, grid 15) and SeparableCNN-128 (10 blocks, 16 patches, grid
    10). The float32 eval forward at B=2, card against CPU, atol 1e-4, TF32
    off, MobileNetV3's weights and non-trivial running statistics imported
    from a reference-layout TorchScript archive; one float32 SAM + SGD step
    of MobileNetV3 at B=2, card against CPU, at phase 8's tolerances, and
    the batch statistics each BatchNorm folds in within 1e-3 (the ``bn3``
    biases, whose gradient is rounding noise, held to a negligible update
    instead); bf16 serving of each family (``predict`` on three odd-sized
    frames, then b64/480), K1 once a call and bit-equal to its plain
    version; bf16 SAM + Adam steps at b8/480 with rotation on the card
    (five of MobileNetV3, two each of the others, the last with train
    metrics): losses finite, params and BatchNorm statistics moving, three
    shear launches a step; ``train_model --model mobilenetv3
    --rotate-device`` for one epoch on 48 / 16 synthetic images, a resume
    (params, statistics, Adam moments and step bit-equal) and
    ``run_validation_epoch`` (MobileNetV3 by default) on its checkpoint;
    timings with CUDA events: b1 ``predict``, b64 forward + decode and the
    b8 train step (three runs: a range) of each family.

The line before the last is a JSON object with each kernel's launches (from
the serving, training, fused, Trainer, SSD and zoo paths), error, times, and its bound: the
larger of the bytes it must move over the card's 3.35 TB/s and the
operations it does on this run's inputs over the 67 TFLOP/s of float32
outside the tensor cores (H100 SXM data sheet). ``library_ms`` is the time
of one ``F.grid_sample`` call (bilinear, zero padding, align_corners) for
the shears' float32 rows, the same function within float32 rounding of its
normalised coordinates; null for the bfloat16 rows (its grid would be
bfloat16 too) and for the other kernels: no single PyTorch call computes a
batched greedy NMS, the photometric chain or the fused tail.
The ``decode_filter_nms``, ``shear_rows``, ``shear_cols`` and
``residual_tail`` entries also list every shape they were timed at
(``shapes``).
The last line is ``{"ok": true, "device": {...}}``. Weights are random,
drawn from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from fdtpu_torch import bench as fbench
from fdtpu_torch import bench_pool_fusion as bpf
from fdtpu_torch import run_validation_epoch, train_model, train_model_ssd
from fdtpu_torch.compat import torch_import
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import augment as aug
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.kernels import build
from fdtpu_torch.kernels import epilogue as kep
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import photometric as kphoto
from fdtpu_torch.kernels import rotate as krot
from fdtpu_torch.losses.ssd import hard_negative_mining
from fdtpu_torch.models.layers import BatchNorm
from fdtpu_torch.models import (
    SSD,
    Detector,
    MobileNetV3Backbone,
    PoolResnet,
    build_model,
    has_batch_stats,
    ssd_patch_sizes,
)
from fdtpu_torch.train import Trainer, create_train_state, make_train_step
from fdtpu_torch.train import step as tstep
from fdtpu_torch.train.checkpoint import latest_checkpoint
from fdtpu_torch.train.sam import global_norm
from fdtpu_torch.utils.config import DetectorConfig, SSDConfig, TrainConfig
from fdtpu_torch.utils.tb import read_scalars

SEED = 0
FORWARD_ATOL = 1e-4  # float32 card vs CPU: summation order only, TF32 off
BENCH_CFG = DetectorConfig(input_shape=(320, 320), num_patches=15, nms_capacity=64)
KERNEL = {
    "name": "decode_filter_nms",
    "route": "cuda",
    "source": "fdtpu_torch/kernels/csrc/decode_filter_nms.cu",
    "replaces": "fdtpu/kernels/nms_pallas.py:197",
}
SHEARS = {
    "shear_rows": {"route": "cuda", "source": "fdtpu_torch/kernels/csrc/rotate_shear.cu",
                   "replaces": "fdtpu/kernels/rotate_pallas.py:197"},
    "shear_cols": {"route": "cuda", "source": "fdtpu_torch/kernels/csrc/rotate_shear.cu",
                   "replaces": "fdtpu/kernels/rotate_pallas.py:232"},
}
PHOTOMETRIC = {"name": "photometric", "route": "cuda",
               "source": "fdtpu_torch/kernels/csrc/photometric.cu",
               "replaces": "fdtpu/kernels/augment_pallas.py:108"}
RESIDUAL_TAIL = {"name": "residual_tail", "route": "cuda",
                 "source": "fdtpu_torch/kernels/csrc/residual_tail.cu",
                 "replaces": "fdtpu/kernels/epilogue_pallas.py:49"}
TRAIN_RTOL_LOSS, TRAIN_RTOL_GRAD_NORM = 1e-4, 1e-3
TRAIN_RTOL_UPDATE, TRAIN_RTOL_UPDATE_TENSOR = 1e-2, 5e-2  # relative L2, phase 8
TRAIN_STEPS = 5
BN_RTOL = 1e-3  # phase 16: the batch statistics a BatchNorm folds in, f32, card vs CPU
FUSED_STEPS = 3
NOISE_ATOL = 1e-6  # K5 with noise on: logf/cosf against PyTorch's log/cos
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9  # H100 SXM: 67 TFLOP/s float32 outside the tensor cores
# operations counted per element (each multiply, add, compare, integer op,
# conversion and transcendental is one)
# K1: the filter's compare on every candidate; the decode of each eligible
# one (score above the threshold); a greedy round's IoU test of each eligible
# one of its image
NMS_FILTER_OPS, NMS_DECODE_OPS, NMS_ROUND_OPS = 1, 17, 14
SHEAR_OPS = 4  # (1 - f) a + f b
# K5, per pixel and channel: brightness/contrast, clip and /255 on every
# plane; the noise (two murmur3 mixes, Box-Muller) and the two 5-tap passes
# on their planes; 2 a motion tap on the motion planes
PHOTO_BASE_OPS, PHOTO_NOISE_OPS, PHOTO_GLASS_OPS = 5, 30, 18
TAIL_OPS = 3  # leaky, add, max, per input element
NMS_TIMED = ((128, 225, 64), (1, 100, 128), (128, 4774, 128))  # (B, N, capacity)
K6_SHAPES = (((128, 128, 40, 40), True), ((128, 128, 20, 20), False),
             ((1, 128, 60, 60), True), ((1, 128, 30, 30), True), ((1, 128, 15, 15), False))
L2_FLUSH_BYTES = 150e6  # three times the H100's 50 MB L2
TRAINER_IMAGES = (48, 16)  # phase 14's synthetic train and val images
TRAINER_EPOCHS = 2
BENCH_LOOPS = (5, 20, 50)  # phase 14's short train, infer and b1 loops, one rep
SSD_CFG = SSDConfig()  # SSD-16, 480 px, patch sizes (60, 30, 15, 7): 4,774 priors
SSD_640 = SSDConfig(input_shape=(640, 640), patch_sizes=ssd_patch_sizes((640, 640)))  # 8,500
SSD_BATCH, SSD_640_BATCH = 24, 8
SSD_FACES = 4  # boxes an image in phase 15's batches
SSD_TRAINER_IMAGES = (192, 24)  # two steps a quarter-epoch at b24, one val batch
# phase 16: the rest of the zoo at 480 px, at the widths their reference
# configurations train at
ZOO_SIZE = 480
ZOO = {
    "mobilenetv3": DetectorConfig(num_patches=15),  # MobileNetV3-Small, grid 480 / 32 = 15
    "resnet": DetectorConfig(filters=64, num_patches=15),  # Resnet-64, 10 blocks, grid 15
    "separable": DetectorConfig(num_patches=16),  # SeparableCNN-128, 10 blocks, grid 10
}
ZOO_SERVE_BATCH, ZOO_TRAIN_BATCH = 64, 8
ZOO_TRAIN_STEPS = {"mobilenetv3": 5, "resnet": 2, "separable": 2}
ZOO_TRAINER_IMAGES = (48, 16)  # six steps at b8, two val batches


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def nms_bound(vals, tables, boxes, mask, prob: float = 0.5) -> tuple[dict, int, int]:
    """K1's bound on this data: every candidate read and compared; only the
    eligible ones (score above ``prob``) decoded and scanned, once a greedy
    round of their image (its kept rows, plus the round that finds none
    alive when fewer than capacity survive), whatever implements it.
    Returns the bound, the rounds and the eligible candidates in all."""
    b, n, _ = vals.shape
    eligible = (vals[..., 0] > prob).sum(-1)
    kept = mask.sum(-1)
    rounds = kept + (kept < mask.shape[-1]).long()
    ops = (b * n * NMS_FILTER_OPS + int(eligible.sum()) * NMS_DECODE_OPS
           + int((rounds * eligible).sum()) * NMS_ROUND_OPS)
    return (bound(nbytes(vals, *tables[:4], boxes, mask), ops), int(rounds.sum()),
            int(eligible.sum()))


# -- inputs ----------------------------------------------------------------------


def candidates(rng, b, n, case, eligible=None):
    """(B, N, 5) rows [conf, x, y, w, h] in the model's [0, 1] units. With
    ``eligible``, exactly that many rows an image score 0.9 and the rest
    0.1, all boxes of zero size (nothing suppresses anything)."""
    v = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
    if eligible is not None:
        v[..., 0] = 0.1
        for i in range(b):
            v[i, rng.choice(n, size=eligible, replace=False), 0] = 0.9
        v[..., 3:] = 0.0
    elif case == "saturated":  # small, mostly disjoint boxes: > capacity survive
        v[..., 3:] = rng.uniform(0.002, 0.03, size=(b, n, 2))
    elif case == "tie":  # three score levels, many exact ties
        v[..., 0] = rng.choice(np.float32([0.3, 0.75, 0.9]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "equal":  # every score the same: the index decides
        v[..., 0] = 0.75
        v[..., 3:] *= 0.1
    elif case == "negative":  # scores in [-1, -0.4]: a score <= -0.5 ends the scan
        v[..., 0] = rng.uniform(-1, -0.4, size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "signed zeros":  # +0.0 and -0.0 tie; the index decides
        v[..., 0] = rng.choice(np.float32([0.0, -0.0, -0.25, -0.6]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "empty":
        v[:] = 0.0
    else:  # random
        v[..., 3:] *= 0.3
    return torch.from_numpy(v).cuda()


def poison(*shapes_dtypes) -> None:
    """Leave NaN / 0xFF blocks of these shapes in the caching allocator, so
    that a kernel which skips an output entry it should write shows it."""
    for shape, dtype in shapes_dtypes:
        t = torch.empty(shape, dtype=dtype, device="cuda")
        t.view(torch.uint8).fill_(0xFF)
        del t


def tables_for(n):
    if n == 4774:  # SSD model output, 480 px
        cols = knms.ssd_output_decode_tables(n, (480, 480))
    elif n > 4774:  # past the shared-memory path: SSD output tables at 632 px
        cols = knms.ssd_output_decode_tables(n, (632, 632))
    else:
        s = int(round(n ** 0.5))
        cols = knms.grid_decode_tables(s, (480, 480) if s == 10 else (320, 320))
    return (*(torch.from_numpy(c).cuda() for c in cols[:4]), *cols[4:])


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_s() -> float:
    """The rate at which ``torch.cuda._sleep`` spins, from one timed sleep."""
    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / (start.elapsed_time(end) / 1e3)


def queue_behind_sleep(host_s: float) -> None:
    """Occupy the card for longer than ``host_s`` seconds of host launches
    (at most half a second), so that the launches queue up behind it."""
    torch.cuda._sleep(int(sleep_cycles_per_s() * min(1.5 * host_s + 1e-3, 0.5)))


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``: the calls are queued behind a
    sleep that outlasts their launches on the host, so the card runs them
    back to back and the CUDA events around them time the card alone, not
    the host's launch cost. (A ``fn`` that synchronises, as a plain
    version's ``nonzero`` does, runs at the host's pace as in
    ``event_ms``.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    queue_behind_sleep(host_s * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Host microseconds one call of ``fn`` takes to launch, with the card
    busy behind a sleep so that no launch waits for a free queue slot."""
    fn()
    torch.cuda.synchronize()
    queue_behind_sleep(2e-4 * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


# -- phases ----------------------------------------------------------------------


def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    card = bpf.card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"[1 card] {name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    return card, name


def phase_build() -> None:
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    build.load_library()
    print(f"[2 build] {build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"({'compiled' if fresh else 'already built'}); max N per image "
          f"{knms.max_candidates(0)}")


def phase_kernel_vs_plain() -> float:
    rng = np.random.default_rng(SEED)
    worst, runs = 0.0, 0

    def same(vals, tables, prob, iou, cap, where):
        nonlocal worst, runs
        b = vals.shape[0]
        # the kernel writes every entry: uninitialised outputs full of 0xFF
        poison(((b, cap, 5), torch.float32), ((b, cap), torch.bool))
        gb, gm = knms.decode_filter_nms_batch(vals, tables, prob, iou, cap)
        wb, wm = knms.decode_filter_nms_reference(vals, tables, prob, iou, cap)
        torch.cuda.synchronize()
        err = (gb - wb).abs().max().item()
        worst = max(worst, err)
        runs += 1
        check(torch.equal(gm, wm), f"masks differ at {where}")
        check(torch.equal(gb, wb), f"boxes differ at {where} (max {err})")
        return gm

    for b in (1, 8, 128):
        for n in (100, 225, 4774):
            tables = tables_for(n)
            for cap in (64, 128):
                for case in ("random", "saturated", "tie", "equal", "empty"):
                    vals = candidates(rng, b, n, case)
                    for prob, iou in ((0.5, 0.5), (0.7, 0.01)):
                        where = f"B={b} N={n} cap={cap} {case} {prob}/{iou}"
                        gm = same(vals, tables, prob, iou, cap, where)
                        if case == "saturated" and prob == 0.5 and n / 2 > 1.5 * cap:
                            check(bool(gm.all()), f"not saturated at {where}")
                        if case == "empty":
                            check(not gm.any(), f"boxes from an empty map at {where}")
                # thresholds below -0.5: negative scores, and +0.0 / -0.0 ties
                for case, prob in (("negative", -0.7), ("signed zeros", -0.3)):
                    vals = candidates(rng, b, n, case)
                    same(vals, tables, prob, 0.5, cap, f"B={b} N={n} cap={cap} {case} {prob}/0.5")
                # eligible counts at the edges: capacity, one above it, and
                # the rank sort's limit of 256 against the bitonic sort's 257
                for m in (cap, cap + 1, 256, 257):
                    if m > n:
                        continue
                    vals = candidates(rng, b, n, None, eligible=m)
                    gm = same(vals, tables, 0.5, 0.5, cap, f"B={b} N={n} cap={cap} M={m}")
                    check(bool((gm.sum(-1) == min(m, cap)).all()), f"M={m} kept != {min(m, cap)}")
    # past the shared-memory limit: the same kernel on global scratch
    large = large_n()
    for b in (1, 8):
        for n in large:
            tables = tables_for(n)
            for case in ("random", "saturated", "tie"):
                vals = candidates(rng, b, n, case)
                gm = same(vals, tables, 0.5, 0.5, 128, f"B={b} N={n} cap=128 {case} (scratch)")
                if case == "saturated":
                    check(bool(gm.all()), f"not saturated at B={b} N={n}")
    print(f"[3 kernel=plain] {runs} cases bit-equal (masks, scores, coordinates; outputs "
          f"allocated over 0xFF): random, saturated, tie, equal, empty, negative scores under "
          f"threshold -0.7, +-0.0 under -0.3, M = cap, cap + 1, 256, 257; past the shared-memory "
          f"limit of {knms.max_candidates(0)} (global scratch): N = {large}, B = 1 and 8, cap 128, "
          f"random, saturated, tie; max |kernel - plain| = {worst}")
    return worst


def large_n() -> tuple[int, ...]:
    """N past the kernel's shared-memory path: one past its limit, the SSD
    map at 632 px, and 20,000."""
    return (knms.max_candidates(0) + 1, 8204, 20000)


def phase_forward_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig()
    cpu = build_model("poolresnet", cfg, "cpu", torch.Generator().manual_seed(SEED)).eval()
    gpu = build_model("poolresnet", cfg, "cuda", torch.Generator().manual_seed(SEED)).eval()
    u8 = np.random.default_rng(SEED + 1).integers(0, 256, size=(2, 480, 480, 3), dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    check(got.shape == (2, 10, 10, 5), f"forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite forward output")
    err = (got - want).abs().max().item()
    live = ((want > 0.01) & (want < 0.99)).float().mean().item()
    check(err <= FORWARD_ATOL, f"card forward differs from CPU by {err} > {FORWARD_ATOL}")
    print(f"[4 forward f32] PoolResnet-128x10 480px B=2, card vs CPU max abs err {err:.3g} "
          f"(atol {FORWARD_ATOL}); {live:.0%} of outputs in (0.01, 0.99)")


def check_boxes(boxes, mask, cap, prob, what):
    check(boxes.shape[-2:] == (cap, 5) and mask.shape[-1] == cap, f"{what} shape")
    check(bool(torch.isfinite(boxes).all()), f"{what} non-finite boxes")
    kept = mask.sum(-1)
    # compacted: the first `kept` rows are valid, the rest are zero
    check(bool((mask == (torch.arange(cap, device=mask.device) < kept[..., None])).all()),
          f"{what} rows not compacted")
    check(bool((boxes[~mask] == 0).all()), f"{what} invalid rows not zero")
    check(bool((boxes[..., 0][mask] > prob).all()), f"{what} score below threshold")
    return kept


def phase_main_path():
    gen = torch.Generator().manual_seed(SEED)
    det480 = Detector(build_model("poolresnet", DetectorConfig(), "cuda", gen))
    det320 = Detector(build_model("poolresnet", BENCH_CFG, "cuda", gen),
                      nms_capacity=BENCH_CFG.nms_capacity)
    rng = np.random.default_rng(SEED + 2)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    batch = torch.from_numpy(
        rng.integers(0, 256, size=(128, 320, 320, 3), dtype=np.uint8)).cuda()

    knms.decode_filter_nms_batch.launches = 0
    preds = [det480.predict(f) for f in frames]
    out = det320.apply(batch.float() / 255.0)
    boxes, mask = det320.non_max_suppression(out)
    torch.cuda.synchronize()
    launches = knms.decode_filter_nms_batch.launches
    check(launches == len(frames) + 1, f"kernel launched {launches} times, want {len(frames) + 1}")

    counts = []
    for norm, b, m in preds:
        check(norm.shape == (480, 480, 3), "predict image shape")
        counts.append(int(check_boxes(b, m, 128, 0.5, "predict")))
    check(out.shape == (128, 15, 15, 5) and out.dtype == torch.float32, "batch forward shape")
    check(bool(torch.isfinite(out).all()), "non-finite batch forward")
    kept = check_boxes(boxes, mask, 64, 0.5, "batch")
    wb, wm = knms.decode_filter_nms_reference(
        out.reshape(128, -1, 5), knms.grid_tables_on(15, (320, 320), out.device), 0.5, 0.5, 64)
    check(torch.equal(mask, wm) and torch.equal(boxes, wb), "batch boxes differ from plain")
    print(f"[5 main path] bf16 Detector on the card: predict x3 at 480px -> {counts} boxes; "
          f"b128 at 320px/grid 15 -> {int(kept.sum())} boxes (min {int(kept.min())}, "
          f"max {int(kept.max())} per image); kernel launches {launches}; "
          f"batch decode equals plain")
    return launches, det480, det320, batch


def mean_of_two(fn, iters: int) -> tuple[float, str]:
    """``device_ms`` twice; the mean and both runs."""
    a, b = device_ms(fn, iters), device_ms(fn, iters)
    return (a + b) / 2, f"runs {a:.4f}/{b:.4f}"


def nms_kernel_alone(vals, tables, cap):
    """A launch of the library's entry point on outputs made once: the
    kernel's time without the wrapper's checks and allocations (and without
    the two zero fills an older wrapper launched before it)."""
    lib = build.load_library()
    b, n, _ = vals.shape
    boxes = torch.zeros((b, cap, 5), device="cuda")
    mask = torch.zeros((b, cap), dtype=torch.bool, device="cuda")
    args = (vals.data_ptr(), *(t.data_ptr() for t in tables[:4]),
            *(float(np.float32(v)) for v in (*tables[4:], 0.5, 0.5)), b, n, cap,
            boxes.data_ptr(), mask.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def launch():
        check(lib.fdtpu_decode_filter_nms(*args) == 0, "decode_filter_nms launch")
        return boxes, mask
    return launch


def nms_times(card, with_plain: bool = True) -> list[dict]:
    """K1/K2 on random maps at the three timed shapes, the card's time alone
    (``device_ms``): through the wrapper as the paths call it (``ms``), the
    kernel alone (``kernel_ms``), and the wrapper's host time a call
    (``host_us``)."""
    rng = np.random.default_rng(SEED + 3)
    rows = []
    for b, n, cap in NMS_TIMED:
        vals = candidates(rng, b, n, "random")
        tables = tables_for(n)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap]}
        if with_plain:
            row["ms"], row["plain_ms"], runs = turns(kern, plain, 50, 3)
        else:
            row["ms"], runs = mean_of_two(kern, 50)
        row["kernel_ms"], alone_runs = mean_of_two(nms_kernel_alone(vals, tables, cap), 50)
        row["host_us"] = host_us(kern, 200)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        plain_txt = f", plain {row['plain_ms']:.4f} ms" if with_plain else ""
        print(f"[6 time] decode_filter_nms B={b} N={n} cap={cap} random maps: wrapper "
              f"{row['ms']:.4f} ms{plain_txt} ({runs}); kernel alone {row['kernel_ms']:.4f} ms "
              f"({alone_runs}); host {row['host_us']:.1f} us a call; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def nms_large_times(card) -> list[dict]:
    """K1's global-scratch path (N past the shared-memory limit) on random
    maps, the card's time alone (``device_ms``) against its plain version."""
    rng = np.random.default_rng(SEED + 12)
    rows = []
    for b, n in ((1, 8204), (8, 8204), (8, 20000)):
        cap = 128
        vals = candidates(rng, b, n, "random")
        tables = tables_for(n)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap], "path": "scratch"}
        row["ms"], row["plain_ms"], runs = turns(kern, plain, 20, 2)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        print(f"[6 time] decode_filter_nms B={b} N={n} cap={cap} random maps, global scratch: "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({runs}); bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def phase_timings(card, det480, det320, batch):
    rows = nms_times(card) + nms_large_times(card)

    def infer():
        return det320.non_max_suppression(det320.apply(batch.float() / 255.0))

    ms = event_ms(infer, 20)
    print(f"[6 time] b128 320px bf16 forward + decode: {ms:.3f} ms/batch, "
          f"{128e3 / ms:.1f} img/s [{card}]")

    frame = np.random.default_rng(SEED + 4).integers(0, 256, size=(480, 480, 3), dtype=np.uint8)
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        _, _, m = det480.predict(frame)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[6 time] b1 predict 480px bf16 (H2D + /255 + forward + decode): median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms over {len(lat)} [{card}]")
    return rows


# -- training -------------------------------------------------------------------


def shear_inputs(x, angles):
    """rotate_batch's first-pass planes ``(K, Hp, Hp * 3)``, its
    coefficients and its center (exact in float32)."""
    padded, _, center, k1, k2 = krot._prepare(x, angles)
    return padded.reshape(*padded.shape[:2], -1), k1, k2, center


def phase_rotate_vs_plain() -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lim = krot.ROTATE_LIMIT_RAD
    worst, runs = 0.0, 0

    def same(got, want, what):
        nonlocal worst, runs
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        runs += 1
        check(got.dtype == want.dtype and torch.equal(got, want), f"{what} differs (max {err})")

    for s in (200, 320, 480):
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 8, 26):
                x = (torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255).to(dtype)
                rand = (torch.rand((max(b, 4),), generator=gen, device="cuda") * 2 - 1) * lim
                pattern = torch.cat([torch.tensor([0.0, lim, -lim], device="cuda"), rand[3:]])
                cases = [pattern[i : i + 1] for i in range(4)] if b == 1 else [pattern[:b]]
                for ang in cases:
                    where = f"B={b} S={s} {dtype} angles {[round(a, 4) for a in ang.tolist()[:4]]}"
                    same(krot.rotate_batch(x, ang), krot.rotate_batch_reference(x, ang),
                         f"rotate_batch at {where}")
                    same(krot.rotate_batch_transposed(x, ang),
                         krot.rotate_batch_transposed_reference(x, ang),
                         f"rotate_batch_transposed (K4) at {where}")
                # every pass on its own, each fed the kernel's previous output
                planes, k1, k2, center = shear_inputs(x, pattern[:b])
                p1 = krot.shear_rows(planes, k1, 3, 0, center)
                same(p1, krot.shear_rows_reference(planes, k1, 3, 0, center),
                     f"shear_rows pass 1 at B={b} S={s} {dtype}")
                p2 = krot.shear_cols(p1, k2, 3, center)
                same(p2, krot.shear_cols_reference(p1, k2, 3, center),
                     f"shear_cols pass 2 at B={b} S={s} {dtype}")
    # the shear kernels' edges, one plane per k: no shear, +-sin of the
    # limit, and shears steep enough that shear_cols stages a band in
    # passes (|k| 1.5 and 3) or reads its taps straight from device memory
    # (k 40); rows not a multiple of the 64-row band (328: S = 200), lanes
    # neither a multiple of the tile nor of 16 bytes (45), c = 1; and each
    # as a view one element into its storage (shear_cols' scalar instance)
    ks = torch.tensor([0.0, math.sin(lim), -math.sin(lim), 0.9, -1.5, 3.0, 40.0], device="cuda")
    for (rows, lanes, c), dtype, offset in itertools.product(
            ((328, 984, 3), (37, 45, 3), (70, 1000, 1)), (torch.float32, torch.bfloat16), (0, 1)):
        numel = len(ks) * rows * lanes
        flat = (torch.rand((numel + offset,), generator=gen, device="cuda") * 255).to(dtype)
        planes = flat[offset:].view(len(ks), rows, lanes)
        center = (rows - 1) / 2.0
        where = f"({len(ks)}, {rows}, {lanes}) c={c} {dtype} offset {offset}"
        same(krot.shear_cols(planes, ks, c, center),
             krot.shear_cols_reference(planes, ks, c, center), f"shear_cols edges {where}")
        same(krot.shear_rows(planes, ks, c, 0, center),
             krot.shear_rows_reference(planes, ks, c, 0, center), f"shear_rows edges {where}")
    torch.cuda.synchronize()
    print(f"[7 rotate=plain] {runs} comparisons bit-equal (rotate_batch, K4's "
          f"rotate_batch_transposed, the passes alone, and the edges: k up to 40, rows 328 "
          f"and 37, lanes 45, c = 1, views at an offset of one element); "
          f"max |kernel - plain| = {worst}")
    return worst


def bench_like_batch(b, size, device):
    """``bench.py``'s train batch: random u8 frames, one face per image."""
    rng = np.random.default_rng(SEED + 6)
    images = rng.integers(0, 255, size=(b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), dtype=np.float32)
    boxes[:, 0] = [1.0, 40, 60, 120, 100]
    masks = np.tile([True, False, False, False], (b, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (images, boxes, masks))


def f32_step_card_vs_cpu(make_module, make_batch, what: str, noise: tuple[str, ...] = ()) -> str:
    """One float32 SAM + SGD step (augmentation off, TF32 off) of
    ``make_module(device)`` on ``make_batch(device)``, on the CPU and on the
    card; checks the loss, the grad norm and the update (params after minus
    before) at phase 8's tolerances and returns the line's numbers.

    Params named with a suffix in ``noise`` have no gradient to match (a
    MobileNetV3 block's last BatchNorm bias: a later train-mode BatchNorm
    subtracts any shift it adds, so its gradient is rounding noise); their
    update must be below 1e-3 of the others' in norm on both devices
    instead. A module with BatchNorm layers has the batch statistics each
    folds into its running ones held too: the running statistics start at
    0, so the step leaves ``(1 - momentum)`` times the batch's mean and
    variance there, and each channel's mean must agree within ``BN_RTOL``
    of its standard deviation and its variance within ``BN_RTOL`` relative
    (BatchNorm's eps added to both). (A relative measure of the change
    alone would not do: a BatchNorm behind a 1x1 conv of a freshly
    normalised input sees a batch mean of 0 up to rounding.)"""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    got = {}
    for dev in ("cpu", "cuda"):
        module = make_module(dev)
        names = [n for n, _ in module.named_parameters()]
        before = [p.detach().cpu().clone() for p in module.parameters()]
        bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
        for bn in bns:
            bn.running_mean.zero_()
            bn.running_var.zero_()
        state = create_train_state(module, tcfg, 100)
        step = make_train_step(module, tcfg, augment=False)
        state, sc = step(state, *make_batch(dev))
        got[dev] = (sc["loss"].item(), sc["grad_norm"].item(),
                    [p.detach().cpu() - q for p, q in zip(module.parameters(), before)],
                    [(bn.running_mean.cpu() / (1 - bn.momentum),
                      bn.running_var.cpu() / (1 - bn.momentum), bn.eps) for bn in bns])
    (l_c, g_c, u_c, s_c), (l_g, g_g, u_g, s_g) = got["cpu"], got["cuda"]
    real = [not n.endswith(noise) for n in names] if noise else [True] * len(names)
    u_c_real = [u for u, r in zip(u_c, real) if r]
    loss_err, gn_err = abs(l_g / l_c - 1), abs(g_g / g_c - 1)
    diff = [a - b for a, b, r in zip(u_g, u_c, real) if r]
    upd_err = global_norm(diff).item() / global_norm(u_c_real).item()
    tensor_err = max((d.norm() / u.norm()).item() for d, u in zip(diff, u_c_real))
    p_err = max(d.abs().max().item() for d in diff)
    check(np.isfinite([l_g, g_g]).all(), f"non-finite f32 {what} step on the card")
    check(loss_err <= TRAIN_RTOL_LOSS, f"{what} loss card {l_g} vs CPU {l_c}")
    check(gn_err <= TRAIN_RTOL_GRAD_NORM, f"{what} grad norm card {g_g} vs CPU {g_c}")
    check(upd_err <= TRAIN_RTOL_UPDATE, f"{what} update differs by {upd_err} in relative L2")
    check(tensor_err <= TRAIN_RTOL_UPDATE_TENSOR,
          f"a {what} tensor's update differs by {tensor_err} in relative L2")
    line = (f"loss {l_g:.6f} vs {l_c:.6f} (rel {loss_err:.3g}, rtol {TRAIN_RTOL_LOSS}); grad norm "
            f"rel {gn_err:.3g} (rtol {TRAIN_RTOL_GRAD_NORM}); update rel L2 {upd_err:.3g} (rtol "
            f"{TRAIN_RTOL_UPDATE}), worst tensor {tensor_err:.3g} (rtol "
            f"{TRAIN_RTOL_UPDATE_TENSOR}); params max abs err {p_err:.3g}")
    if noise:
        ratio = max(global_norm([u for u, r in zip(upd, real) if not r]).item()
                    / global_norm([u for u, r in zip(upd, real) if r]).item()
                    for upd in (u_c, u_g))
        check(ratio <= 1e-3, f"{what} {noise} updates {ratio} of the others' in norm")
        line += f"; {real.count(False)} {'/'.join(noise)} tensors' update {ratio:.3g} of the rest"
    if s_c:
        mean_err = max(((mg - mc).abs() / (vc + eps).sqrt()).max().item()
                       for (mg, _, _), (mc, vc, eps) in zip(s_g, s_c))
        var_err = max(((vg - vc).abs() / (vc + eps)).max().item()
                      for (_, vg, _), (_, vc, eps) in zip(s_g, s_c))
        check(max(mean_err, var_err) <= BN_RTOL,
              f"{what} BatchNorm batch statistics differ: means by {mean_err} of the std, "
              f"variances by {var_err}")
        line += (f"; the batch statistics {len(s_c)} BatchNorms fold in: means within "
                 f"{mean_err:.3g} of the std, variances {var_err:.3g} relative (tol {BN_RTOL})")
    return line


def phase_train_f32() -> None:
    cfg = DetectorConfig()

    def module(dev):
        return PoolResnet(cfg.filters, cfg.input_shape, cfg.num_patches, cfg.num_residual_blocks,
                          dropout=0.0, head_dropout=0.0,
                          generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    line = f32_step_card_vs_cpu(module, lambda dev: bench_like_batch(2, 480, dev), "PoolResnet")
    print(f"[8 train f32] SAM + SGD step, PoolResnet-128x10 480px B=2, card vs CPU: {line}")


def train_setup(cfg: DetectorConfig, b: int):
    module = build_model("poolresnet", cfg, "cuda", torch.Generator().manual_seed(SEED),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED)
    state = create_train_state(module, tcfg, 100)
    steps = (make_train_step(module, tcfg), make_train_step(module, tcfg, compute_metrics=True))
    return state, steps, bench_like_batch(b, cfg.input_shape[0], "cuda")


def phase_train_path():
    runs = {"b128-320": train_setup(BENCH_CFG, 128), "b8-480": train_setup(DetectorConfig(), 8)}
    before = {k: [p.detach().clone() for p in st.module.parameters()]
              for k, (st, _, _) in runs.items()}

    krot.shear_rows.launches = krot.shear_cols.launches = 0
    knms.decode_filter_nms_batch.launches = 0
    scalars = {}
    for key, (state, (step, metrics_step), batch) in runs.items():
        for i in range(TRAIN_STEPS):
            state, sc = (metrics_step if i == TRAIN_STEPS - 1 else step)(state, *batch)
            scalars.setdefault(key, []).append(sc)
    torch.cuda.synchronize()
    launches = {"shear_rows": krot.shear_rows.launches, "shear_cols": krot.shear_cols.launches,
                "decode_filter_nms": knms.decode_filter_nms_batch.launches}

    calls = TRAIN_STEPS * len(runs)  # one rotate_batch per step
    check(launches["shear_rows"] == 2 * calls and launches["shear_cols"] == calls,
          f"shear launches {launches}, want {2 * calls} and {calls}")
    check(launches["decode_filter_nms"] == len(runs), f"NMS launches {launches}, want {len(runs)}")
    for key, (state, _, _) in runs.items():
        check(state.step == TRAIN_STEPS, f"{key} stepped {state.step} times")
        losses = [sc["loss"].item() for sc in scalars[key]]
        check(all(np.isfinite(v) for sc in scalars[key] for v in
                  (t.item() for t in sc.values())), f"{key} non-finite scalars")
        moved = max((p - q).abs().max().item()
                    for p, q in zip(state.module.parameters(), before[key]))
        check(moved > 0, f"{key} params did not move")
        check(all(p.dtype == torch.float32 for p in state.module.parameters()),
              f"{key} params left float32")
        last = scalars[key][-1]
        print(f"[9 train path] {key}: losses {[round(v, 3) for v in losses]}, grad norm "
              f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f} recall "
              f"{last['recall'].item():.4f} precision {last['precision'].item():.4f}; params "
              f"moved up to {moved:.3g}")
    print(f"[9 train path] launches: shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']} ({calls} rotate_batch calls), decode_filter_nms "
          f"{launches['decode_filter_nms']} ({len(runs)} metrics steps)")
    return launches, runs


def step_ms(state, step, batch, iters: int) -> float:
    def once():
        step(state, *batch)
    return event_ms(once, iters, warmup=5)


def phase_train_timings(card, runs):
    state, (step, _), batch = runs["b128-320"]
    step_off = make_train_step(state.module, TrainConfig(positional_crop=True, seed=SEED))
    # on, off, off, on: drift on the card hits both alike
    on1, off1, off2, on2 = (step_ms(state, f, batch, 30) for f in (step, step_off, step_off, step))
    on, off = (on1 + on2) / 2, (off1 + off2) / 2
    print(f"[10 time] train b128 320px bf16 SAM+Adam rotation on: {on:.3f} ms/step "
          f"({128e3 / on:.1f} img/s; runs {on1:.3f}/{on2:.3f}); rotation off: {off:.3f} ms/step "
          f"({128e3 / off:.1f} img/s; runs {off1:.3f}/{off2:.3f}) [{card}]")
    state8, (step8, _), batch8 = runs["b8-480"]
    ms8 = step_ms(state8, step8, batch8, 30)
    print(f"[10 time] train b8 480px bf16 SAM+Adam rotation on: {ms8:.3f} ms/step "
          f"({8e3 / ms8:.1f} img/s) [{card}]")

    return shear_times(card)


def shear_grids(k, center: float, hp: int):
    """``F.grid_sample`` grids (align_corners, pixel units normalised by
    ``hp - 1``) of the row shear (sample row ``y`` at ``x + k (y -
    center)``) and of the column shear (column ``x`` at ``y + k (x -
    center)``) of ``(K, 3, hp, hp)`` images; the offsets are the plain
    versions' float32 ``t``, the unsheared coordinate sits on a pixel
    centre."""
    pos = torch.arange(hp, device=k.device, dtype=torch.float32)
    t = k[:, None] * (pos - center)  # (K, hp)
    along = pos[None, None, :] + t[:, :, None]  # [i, y, x] = x + t_i(y)
    fixed = pos[None, :, None].expand_as(along)
    norm = lambda v: v * (2.0 / (hp - 1)) - 1.0  # noqa: E731
    rows = torch.stack([norm(along), norm(fixed)], dim=-1)  # (x', y)
    cols = torch.stack([norm(fixed.transpose(1, 2)), norm(along.transpose(1, 2))], dim=-1)
    return rows.contiguous(), cols.contiguous()


def grid_sample(img, grid):
    return torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=True)


def shear_times(card, with_plain: bool = True) -> list[dict]:
    """K3a, K3b and K4 on the planes the training path gives them: the
    26-image exact-k subset at b128/320 in bf16, all 8 images at b8/480 in
    float32; the card's time alone (``device_ms``). With ``with_plain``, also
    the library call: one ``F.grid_sample`` (bilinear, zero padding,
    align_corners) of the same planes seen as ``(K, 3, Hp, Hp)`` images,
    its time and its largest difference from the plain version. In bfloat16
    the grid is bfloat16 too (its coordinates, up to 767, in steps of 2 to
    4), so there it is not the same function: no ``library_ms``, the error
    is given."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for b, s, dtype in ((26, 320, torch.bfloat16), (8, 480, torch.float32)):
        x = (torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255).to(dtype)
        ang = (torch.rand((b,), generator=gen, device="cuda") * 2 - 1) * krot.ROTATE_LIMIT_RAD
        planes, k1, k2, ctr = shear_inputs(x, ang)
        hp = planes.shape[1]
        # K4's layout: channels stacked on rows, a row shear with c = 1
        stacked = planes.reshape(b, hp, hp, 3).permute(0, 3, 1, 2).reshape(b, 3 * hp, hp)
        image = planes.reshape(b, hp, hp, 3).permute(0, 3, 1, 2)  # a view: channels_last
        grid_rows, _ = shear_grids(k1, ctr, hp)
        _, grid_cols = shear_grids(k2, ctr, hp)
        pairs = {
            "shear_rows": (lambda: krot.shear_rows(planes, k1, 3, 0, ctr),
                           lambda: krot.shear_rows_reference(planes, k1, 3, 0, ctr),
                           lambda g: grid_sample(image, g), grid_rows,
                           lambda o: o.permute(0, 2, 3, 1).reshape(b, hp, 3 * hp)),
            "shear_cols": (lambda: krot.shear_cols(planes, k2, 3, ctr),
                           lambda: krot.shear_cols_reference(planes, k2, 3, ctr),
                           lambda g: grid_sample(image, g), grid_cols,
                           lambda o: o.permute(0, 2, 3, 1).reshape(b, hp, 3 * hp)),
            "shear_rows, K4 layout": (
                lambda: krot.shear_rows(stacked, k1, 1, hp, ctr),
                lambda: krot.shear_rows_reference(stacked, k1, 1, hp, ctr),
                lambda g: grid_sample(stacked.view(b, 3, hp, hp), g), grid_rows,
                lambda o: o.reshape(b, 3 * hp, hp)),
        }
        for name, (kern, plain, library, grid, layout) in pairs.items():
            shape = tuple((stacked if "K4" in name else planes).shape)
            # each pass reads its planes once and writes them once
            row = {"name": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   **bound(2 * nbytes(planes), SHEAR_OPS * planes.numel())}
            if with_plain:
                row["ms"], row["plain_ms"], runs = turns(kern, plain, 50, 5)
                grid = grid.to(dtype)
                err = (layout(library(grid)).float() - plain().float()).abs().max().item()
                row["library_max_abs_err"] = err
                if dtype == torch.float32:
                    row["library_ms"], lib_runs = mean_of_two(lambda: library(grid), 50)
                    lib_txt = (f"; library F.grid_sample {row['library_ms']:.4f} ms ({lib_runs}), "
                               f"max abs err {err:.3g} against plain on 0-255 planes")
                else:
                    row["library_ms"] = None
                    lib_txt = (f"; F.grid_sample takes a bf16 grid with bf16 planes: max abs err "
                               f"{err:.3g}, not the same function")
            else:
                row["ms"], runs = mean_of_two(kern, 50)
                lib_txt = ""
            rows.append(row)
            plain_txt = f", plain {row['plain_ms']:.4f} ms" if with_plain else ""
            print(f"[10 time] {name} {shape} {dtype}: kernel {row['ms']:.4f} ms{plain_txt} "
                  f"({runs}); bound {row['bound_ms']:.4f} ms by {row['bound_by']}{lib_txt} "
                  f"[{card}]")
    return rows


# -- the fused kernels: K5 and K6 ----------------------------------------------------


def photometric_table(gen, b, noise, glass, motion, bins=None, bc=True):
    """A ``(B, 8)`` scalar table on the card: brightness/contrast drawn for
    every row (with ``bc``), and each gate on for a random half of the rows
    where its argument is True (all rows for "all")."""
    def gate(on):
        if on == "all":
            return torch.ones((b,), device="cuda")
        return (torch.rand((b,), generator=gen, device="cuda") < 0.5).float() if on else \
            torch.zeros((b,), device="cuda")

    u = lambda: torch.rand((b,), generator=gen, device="cuda")  # noqa: E731
    sc = torch.zeros((b, 8), device="cuda")
    sc[:, kphoto.ALPHA] = 1.0 + (u() * 0.4 - 0.2 if bc else 0.0)
    sc[:, kphoto.BETA] = (u() * 0.4 - 0.2) * 255.0 if bc else 0.0
    sc[:, kphoto.NOISE_SIGMA] = gate(noise) * torch.sqrt(10.0 + u() * 390.0)
    sc[:, kphoto.GLASS] = gate(glass)
    sc[:, kphoto.MOTION] = gate(motion)
    sc[:, kphoto.MDX] = (torch.randint(0, 16, (b,), generator=gen, device="cuda").float()
                         if bins is None else bins)
    return sc


def photometric_seeds(gen, b, fixed=None):
    seeds = torch.randint(0, 2**31 - 1, (3 * b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    if fixed is not None:
        seeds[: min(3, 3 * b)] = fixed
    return seeds


def phase_photometric_vs_plain() -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst, runs, noise_exact = 0.0, 0, True
    cases = {
        "identity": dict(noise=False, glass=False, motion=False, bc=False),
        "brightness/contrast": dict(noise=False, glass=False, motion=False),
        "noise, seed 0": dict(noise="all", glass=False, motion=False, fixed=0),
        "noise, seed 2^31-2": dict(noise="all", glass=False, motion=False, fixed=2**31 - 2),
        "noise, random seeds": dict(noise=True, glass=False, motion=False),
        "glass": dict(noise=False, glass="all", motion=False),
        "motion": dict(noise=False, glass=False, motion="all"),
        "gates mixed": dict(noise=True, glass=True, motion=True),
        "all gates": dict(noise="all", glass="all", motion="all"),
    }

    def compare(imgs, sc, seeds, noised, where):
        nonlocal worst, runs, noise_exact
        got = kphoto.photometric_batch(imgs, sc, seeds)
        want = kphoto.photometric_reference(imgs, sc, seeds)
        err = (got - want).abs().max().item()
        runs += 1
        check(got.shape == imgs.shape and got.dtype == torch.float32, f"K5 output at {where}")
        if noised:
            worst = max(worst, err)
            noise_exact = noise_exact and torch.equal(got, want)
            check(err <= NOISE_ATOL, f"K5 differs by {err} > {NOISE_ATOL} at {where}")
        else:
            check(torch.equal(got, want), f"K5 differs by {err} at {where} (noise off)")

    for b in (1, 26, 128):
        for s in (64, 320, 480):
            imgs = torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255.0
            for case, kw in cases.items():
                kw = dict(kw)
                seeds = photometric_seeds(gen, b, kw.pop("fixed", None))
                sc = photometric_table(gen, b, **kw)
                compare(imgs, sc, seeds, bool(sc[:, kphoto.NOISE_SIGMA].any()),
                        f"B={b} S={s} {case}")
    # halo-free and blurred images in one batch, every one noised: rows
    # cycle through no blur, glass, motion and both (the kernel picks its
    # path per CTA); odd sides put row starts, image starts and the buffer's
    # end off the 16-byte grid; a view at an odd offset takes the wrapper's
    # aligned copy
    for b, h, w in ((128, 320, 320), (8, 37, 45), (5, 33, 70)):
        imgs = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
        sc = photometric_table(gen, b, "all", False, False)
        sc[:, kphoto.GLASS] = (torch.arange(b, device="cuda") % 4 % 2).float()
        sc[:, kphoto.MOTION] = (torch.arange(b, device="cuda") % 4 >= 2).float()
        compare(imgs, sc, photometric_seeds(gen, b), True,
                f"B={b} {h}x{w} halo-free and blurred rows, all noised")
    flat = torch.rand((3 * 37 * 45 * 3 + 1,), generator=gen, device="cuda") * 255.0
    compare(flat[1:].view(3, 37, 45, 3), photometric_table(gen, 3, True, True, True),
            photometric_seeds(gen, 3), True, "B=3 37x45 at an offset of one float")

    imgs = torch.rand((16, 64, 64, 3), generator=gen, device="cuda") * 255.0
    bins = torch.arange(16, device="cuda").float()
    compare(imgs, photometric_table(gen, 16, False, False, "all", bins=bins),
            photometric_seeds(gen, 16), False, "B=16 S=64, motion bins 0..15")
    compare(imgs[:1].expand(16, -1, -1, -1).contiguous(),
            photometric_table(gen, 16, "all", "all", "all", bins=bins),
            photometric_seeds(gen, 16), True, "B=16 S=64 one image, all gates, bins 0..15")

    # the whole fused exact-k augmentation at the train shape, the kernel's
    # route against the same route with the plain version in its place
    x, bx, m = bench_like_batch(128, 320, "cuda")
    d = aug.sample_exact_k(torch.Generator(device="cuda").manual_seed(SEED), 128, 320, 320,
                           "cuda", rotate=True, positional_crop=True, fused_photometric=True)
    got = aug.apply_exact_k(x, bx, m, d, fused_photometric=True)
    aug.photometric_batch = kphoto.photometric_reference
    try:
        want = aug.apply_exact_k(x, bx, m, d, fused_photometric=True)
    finally:
        aug.photometric_batch = kphoto.photometric_batch
    err = (got[0] - want[0]).abs().max().item()
    worst = max(worst, err)
    noise_exact = noise_exact and torch.equal(got[0], want[0])
    check(err <= NOISE_ATOL, f"fused exact-k augmentation differs by {err}")
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "fused exact-k augmentation boxes or masks differ")
    check(got[0].dtype == torch.float32 and 0 <= got[0].min() and got[0].max() <= 1,
          "fused exact-k augmentation output range")
    torch.cuda.synchronize()
    print(f"[11 photometric=plain] {runs} cases and the fused exact-k augmentation at b128/320 "
          f"(rotation, {int((d.scalars[:, kphoto.NOISE_SIGMA] > 0).sum())} noised images): "
          f"noise off bit-equal; noise on "
          f"{'bit-equal' if noise_exact else f'within {NOISE_ATOL}'}, max |kernel - plain| = "
          f"{worst}")
    return worst


def tail_operands(gen, shape, dtype, fmt, offset=0):
    """``c2``, ``skip`` and a conv-like ``bias`` on the card; with
    ``offset``, ``c2`` and ``skip`` are views ``offset`` elements into their
    storage."""
    def one():
        n, c, h, w = shape
        flat = (torch.randn((n * c * h * w + offset,), generator=gen, device="cuda") * 3).to(dtype)
        t = flat[offset:]
        if fmt == torch.channels_last:
            return t.view(n, h, w, c).permute(0, 3, 1, 2)
        return t.view(shape)

    bias = (torch.randn((shape[1],), generator=gen, device="cuda") * 0.5).to(dtype)
    return one(), one(), bias


def phase_tail_vs_plain() -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    runs = 0

    def same(c2, skip, pool, bias, where):
        nonlocal runs
        fmt = torch.contiguous_format if c2.is_contiguous() else torch.channels_last
        got = kep.fused_residual_tail(c2, skip, pool=pool, bias=bias)
        want = kep.reference_tail(c2, skip, pool, bias)
        runs += 1
        check(got.dtype == want.dtype and torch.equal(got, want), f"K6 differs at {where}")
        check(got.is_contiguous(memory_format=fmt), f"K6 output layout at {where}")

    # the main paths' shapes, and the edges: C not a multiple of 8, a numel
    # not a multiple of 8 (unpooled), odd widths
    shapes = ((128, 128, 40, 40), (128, 128, 20, 20), (1, 128, 60, 60), (1, 128, 30, 30),
              (4, 12, 20, 20), (3, 5, 7, 9), (2, 6, 6, 10))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.channels_last, torch.contiguous_format):
                c2, skip, bias = tail_operands(gen, shape, dtype, fmt)
                for pool in (True, False):
                    if pool and (shape[2] % 2 or shape[3] % 2):
                        continue
                    for b in (None, bias):
                        same(c2, skip, pool, b, f"{shape} {dtype} {fmt} pool={pool} "
                                                f"bias={b is not None}")
                # inputs 16-byte misaligned: both (out stays aligned), or c2 alone
                c2o, skipo, _ = tail_operands(gen, shape, dtype, fmt, offset=1)
                for pool in (True, False):
                    if pool and (shape[2] % 2 or shape[3] % 2):
                        continue
                    same(c2o, skipo, pool, bias, f"{shape} {dtype} {fmt} pool={pool} offset 1")
                    same(c2o, skip, pool, None, f"{shape} {dtype} {fmt} pool={pool} c2 offset 1")
    torch.cuda.synchronize()
    print(f"[12 tail=plain] {runs} cases bit-equal (float32 and bfloat16, pooled and "
          f"unpooled, channels_last and contiguous, with and without the bias; C = 12 and 5, "
          f"numel 945, inputs at an offset of one element)")


def phase_tail_path():
    """The K6 path: ``Detector.apply`` with every block's tail fused (conv2's
    bias folded in), against the eager forward of the same Detector."""
    shapes = {"b128-320": (128, BENCH_CFG), "b1-480": (1, DetectorConfig())}
    dets = {key: Detector(build_model("poolresnet", cfg, "cuda",
                                      torch.Generator().manual_seed(SEED)))
            for key, (_, cfg) in shapes.items()}
    images = {key: bpf.frames(b, cfg.input_shape[0], SEED + 10) for key, (b, cfg) in shapes.items()}
    eager = {key: dets[key].apply(images[key]) for key in shapes}

    kep.fused_residual_tail.launches = 0
    for det in dets.values():
        bpf.set_fused_tail(det.net, True)
    fused = {key: dets[key].apply(images[key]) for key in shapes}
    torch.cuda.synchronize()
    launches = kep.fused_residual_tail.launches
    for det in dets.values():
        bpf.set_fused_tail(det.net, False)

    blocks = sum(len(det.net.residual_blocks) for det in dets.values())
    check(launches == blocks, f"tail kernel launched {launches} times, want {blocks}")
    for key in shapes:
        check(bool(torch.isfinite(fused[key]).all()), f"{key} non-finite fused forward")
        check(torch.equal(fused[key], eager[key]), f"{key} fused forward differs from eager")
    print(f"[12 tail path] Detector.apply with fused_tail at b128/320 and b1/480 bit-equal to "
          f"the eager forward; tail kernel launches {launches} ({blocks} blocks)")
    return launches


def phase_photometric_path():
    """The K5 path: bf16 train steps at b128/320 with rotation through the
    fused photometric kernel."""
    module = build_model("poolresnet", BENCH_CFG, "cuda", torch.Generator().manual_seed(SEED),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED,
                       fused_photometric=True)
    state = create_train_state(module, tcfg, 100)
    step = make_train_step(module, tcfg)
    batch = bench_like_batch(128, 320, "cuda")

    kphoto.photometric_batch.launches = 0
    krot.shear_rows.launches = krot.shear_cols.launches = 0
    losses, counts = [], []
    for _ in range(FUSED_STEPS):
        state, sc = step(state, *batch)
        losses.append(sc["loss"].item())
        counts.append(kphoto.photometric_batch.launches)
    torch.cuda.synchronize()
    launches = {"photometric": kphoto.photometric_batch.launches,
                "shear_rows": krot.shear_rows.launches, "shear_cols": krot.shear_cols.launches}

    check(counts == list(range(1, FUSED_STEPS + 1)), f"photometric launches by step {counts}")
    check(launches["shear_rows"] == 2 * FUSED_STEPS and launches["shear_cols"] == FUSED_STEPS,
          f"shear launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    print(f"[13 photometric path] {FUSED_STEPS} bf16 SAM+Adam steps at b128/320 with rotation and "
          f"fused_photometric: losses {[round(v, 3) for v in losses]}; photometric launches by "
          f"step {counts}, shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']}")
    return launches, (state, step, batch)


def photometric_bound(imgs, sc, seeds) -> dict:
    """K5's bound on these inputs: every pixel read and written once; the
    noise, the Gaussian and the motion taps counted only on their planes."""
    plane = imgs[0].numel()
    taps = torch.tensor([len(t) for t in kphoto.MOTION_TAPS], device=sc.device)
    bins = sc[:, kphoto.MDX].long().clamp(0, kphoto.N_DIRS - 1)
    moving = sc[:, kphoto.MOTION] > 0.5
    ops = plane * (PHOTO_BASE_OPS * imgs.shape[0]
                   + PHOTO_NOISE_OPS * int((sc[:, kphoto.NOISE_SIGMA] != 0).sum())
                   + PHOTO_GLASS_OPS * int((sc[:, kphoto.GLASS] > 0.5).sum())
                   + 2 * int(taps[bins][moving].sum()))
    return bound(2 * nbytes(imgs) + nbytes(sc, seeds), ops)


def tail_bound(c2, skip, pool: bool, bias=None) -> dict:
    out = c2.numel() // 4 if pool else c2.numel()
    extra = (bias is not None) * c2.numel()  # the bias add
    return bound(nbytes(c2, skip, *(() if bias is None else (bias,))) + out * c2.element_size(),
                 TAIL_OPS * c2.numel() + extra)


def turns(kern, plain, iters: int, plain_iters: int) -> tuple[float, float, str]:
    """Kernel and plain times on the card (``device_ms``): plain, kernel,
    kernel, plain, so that drift on the card hits both alike."""
    p1, k1, k2, p2 = (device_ms(f, n) for f, n in
                      ((plain, plain_iters), (kern, iters), (kern, iters), (plain, plain_iters)))
    return (k1 + k2) / 2, (p1 + p2) / 2, f"runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}"


def cycling(fn, operands):
    """A call of ``fn`` on the next operands of the list, round and round."""
    it = itertools.cycle(operands)
    return lambda: fn(*next(it))


def photometric_times(card, gen) -> dict:
    """K5 at the train shape, b128/320 float32, on four tables: the exact-k
    table of the fused route (26 rows each noised, glass-blurred and
    motion-blurred; the row of record), every gate off, the noise on every
    row, and both blurs on every row (noise off). Brightness/contrast as the
    fused route drew it in all four. Each split shows what a stage costs."""
    d = aug.sample_exact_k(gen, 128, 320, 320, "cuda", rotate=True, positional_crop=True,
                           fused_photometric=True)
    imgs = torch.rand((128, 320, 320, 3), generator=gen, device="cuda") * 255.0
    off = d.scalars.clone()
    off[:, [kphoto.NOISE_SIGMA, kphoto.GLASS, kphoto.MOTION]] = 0.0
    noise, blurs = off.clone(), off.clone()
    noise[:, kphoto.NOISE_SIGMA] = torch.sqrt(
        10.0 + torch.rand((128,), generator=gen, device="cuda") * 390.0)
    blurs[:, [kphoto.GLASS, kphoto.MOTION]] = 1.0
    out = {}
    for table, sc in (("the fused route's table", d.scalars), ("gates off", off),
                      ("noise on every row", noise), ("both blurs on every row", blurs)):
        ms, plain, runs = turns(lambda sc=sc: kphoto.photometric_batch(imgs, sc, d.seeds),
                                lambda sc=sc: kphoto.photometric_reference(imgs, sc, d.seeds),
                                20, 3)
        bnd = photometric_bound(imgs, sc, d.seeds)
        out[table] = (ms, plain, bnd)
        print(f"[13 time] photometric (128, 320, 320, 3) float32, {table}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms ({runs}); bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} [{card}]")
    return out


def tail_times(card, gen, with_bias: bool = True) -> list[dict]:
    """K6 at the eval forward's shapes, bf16 channels_last: at b128/320
    block 0 pools and blocks 1-9 do not; at b1/480 blocks 0 and 1 pool and
    blocks 2-9 do not. ``with_bias``: conv2's bias folded in, as the
    ``fused_tail`` forward runs it on the card, and the plain version adds
    it first, as the eager forward does. Each shape twice: warm, the same
    inputs every launch (at b128 an unpooled block's 26 MB of inputs stay in
    the 50 MB L2), and cold, cycling through enough input sets that each
    launch finds its inputs out of L2. Times are the card's alone
    (``device_ms``); the host's launch cost of one call is ``host_us``."""
    rows = []
    for shape, pool in K6_SHAPES:
        sets = [tail_operands(gen, shape, torch.bfloat16, torch.channels_last)]
        while len(sets) * nbytes(*sets[0][:2]) < L2_FLUSH_BYTES:
            sets.append(tail_operands(gen, shape, torch.bfloat16, torch.channels_last))
        if with_bias:
            def kern(c, s, b, pool=pool):
                return kep.fused_residual_tail(c, s, pool=pool, bias=b)

            def plain(c, s, b, pool=pool):
                return kep.reference_tail(c, s, pool, b)
        else:
            def kern(c, s, b, pool=pool):
                return kep.fused_residual_tail(c, s, pool=pool)

            def plain(c, s, b, pool=pool):
                return kep.reference_tail(c, s, pool)
        c2, skip, bias = sets[0]
        row = {"shape": list(shape), "pool": pool, "bias": with_bias,
               **tail_bound(c2, skip, pool, bias if with_bias else None)}
        for l2, operands in (("warm", sets[:1]), ("cold", sets)):
            ms, plain_ms, runs = turns(cycling(kern, operands), cycling(plain, operands), 50, 50)
            row[f"ms_{l2}"], row[f"plain_ms_{l2}"] = ms, plain_ms
            print(f"[13 time] residual_tail {shape} bf16 channels_last pool={pool} "
                  f"bias={with_bias}, {l2} L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({runs}); bound {row['bound_ms']:.4f} ms by {row['bound_by']} [{card}]")
        row["host_us"] = host_us(lambda: kern(c2, skip, bias), 200)
        row["plain_host_us"] = host_us(lambda: plain(c2, skip, bias), 200)
        print(f"[13 time] residual_tail {shape} pool={pool} bias={with_bias}: host "
              f"{row['host_us']:.1f} us a call, plain {row['plain_host_us']:.1f} us [{card}]")
        rows.append(row)
    return rows


def phase_fused_timings(card, train):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    photo = photometric_times(card, gen)
    tails = tail_times(card, gen) + tail_times(card, gen, with_bias=False)
    # the kernels line: K5 on the fused route's table; K6 at its most
    # launched shape, b128 unpooled with the bias (nine launches of ten a
    # b128 forward), warm, beside every shape it was timed at
    top = next(r for r in tails if r["shape"] == [128, 128, 20, 20] and r["bias"])
    times = {"photometric": photo["the fused route's table"],
             "residual_tail": (top["ms_warm"], top["plain_ms_warm"],
                               {k: top[k] for k in ("bound_ms", "bound_by")}),
             "residual_tail_shapes": tails}

    state, fused_step, batch = train
    default_step = make_train_step(state.module, TrainConfig(rotate_device=True,
                                                             positional_crop=True, seed=SEED))
    # fused, default, default, fused: drift on the card hits both alike
    f1, d1, d2, f2 = (step_ms(state, f, batch, 20)
                      for f in (fused_step, default_step, default_step, fused_step))
    print(f"[13 time] train b128 320px bf16 SAM+Adam rotation on, fused_photometric: "
          f"{(f1 + f2) / 2:.3f} ms/step (runs {f1:.3f}/{f2:.3f}); default chain: "
          f"{(d1 + d2) / 2:.3f} ms/step (runs {d1:.3f}/{d2:.3f}) [{card}]")
    for b, size, grid in ((128, 320, 15), (1, 480, 10)):
        r = bpf.measure(b, size, grid, iters=20)
        runs = "; ".join(f"{arm} {'/'.join(f'{t:.4f}' for t in r[f'fwd_{arm}_runs_ms'])}"
                         for arm in bpf.ARMS)
        print(f"[13 time] bench_pool_fusion b{b} {size}px: prod {r['fwd_prod_ms']:.4f} ms, "
              f"slicemax {r['fwd_slicemax_ms']:.4f} ms, fused {r['fwd_fused_ms']:.4f} ms a forward "
              f"(runs {runs}; all bit-equal to prod) [{card}]")
    return times


# -- the Trainer path --------------------------------------------------------------


def kernel_counts() -> dict:
    return {"decode_filter_nms": knms.decode_filter_nms_batch.launches,
            "shear_rows": krot.shear_rows.launches, "shear_cols": krot.shear_cols.launches}


def counts_since(start: dict) -> dict:
    return {k: v - start[k] for k, v in kernel_counts().items()}


def trainer_loaders(root, shuffle: bool):
    shape = DetectorConfig().input_shape
    train = WIDERFaceDataSource(load_targets(root, "train", 3), shape, 8, error_log=None)
    val = WIDERFaceDataSource(load_targets(root, "val", 3), shape, 8, error_log=None)
    return BatchLoader(train, 8, shuffle=shuffle, seed=SEED, drop_last=True), BatchLoader(val, 8)


def trainer_module(seed: int, dtype=torch.bfloat16):
    return build_model("poolresnet", DetectorConfig(), "cuda", torch.Generator().manual_seed(seed),
                       compute_dtype=dtype)


def bench_py_keys() -> set[str]:
    """The keys of ``bench.py``'s result line, read from its source."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def phase_trainer(tmp) -> dict:
    """14: the Trainer path at full width (``DetectorConfig()``,
    ``TrainConfig()`` defaults but rotation on the card and no first-batch
    drawings), b8, on ``make_synthetic_widerface`` data. Returns the kernel
    launches of the whole phase."""
    from pathlib import Path

    tmp = Path(tmp)
    n_train, n_val = TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    phase_start = kernel_counts()
    tcfg = TrainConfig(rotate_device=True, max_epochs=TRAINER_EPOCHS, seed=SEED,
                       visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                       log_path=str(tmp / "logs" / "out.log"))

    # fit, two epochs, streamed
    train, val = trainer_loaders(root, shuffle=True)
    trainer = Trainer(trainer_module(SEED), tcfg, train, val, run_name="smoke", device="cuda")
    before = [p.detach().clone() for p in trainer.state.module.parameters()]
    start = kernel_counts()
    out = trainer.fit()
    torch.cuda.synchronize()
    fit = counts_since(start)
    steps, val_batches = TRAINER_EPOCHS * len(train), len(val)
    check(trainer.state.step == steps, f"Trainer took {trainer.state.step} steps, want {steps}")
    check(all(np.isfinite(v) for split in out.values() for v in split.values()),
          f"non-finite epoch metrics {out}")
    moved = max((p - q).abs().max().item()
                for p, q in zip(trainer.state.module.parameters(), before))
    check(moved > 0, "Trainer params did not move")
    want_k1 = TRAINER_EPOCHS * (1 + val_batches)  # the metrics step, then each val batch
    check(fit["decode_filter_nms"] == want_k1,
          f"K1 launched {fit['decode_filter_nms']} times in fit, want {want_k1}")
    check(fit["shear_rows"] == 2 * steps and fit["shear_cols"] == steps,
          f"shear launches {fit} over {steps} rotating steps")
    logs = tmp / "logs"
    lines = (logs / "out.log").read_text().splitlines()
    records = (logs / "out.jsonl").read_text().splitlines()
    (tb,) = (logs / "tb").glob("events.out.tfevents.*")
    check(len(lines) == len(records) == len(read_scalars(tb)) == 2 * TRAINER_EPOCHS,
          "log, jsonl and TensorBoard records")
    ckpts = sorted(p.name for p in (tmp / "ckpt" / "smoke").glob("step_*.pt"))
    want_ckpts = [f"step_{len(train) * (e + 1):08d}.pt" for e in range(TRAINER_EPOCHS)]
    check(ckpts == want_ckpts, f"checkpoints {ckpts}, want {want_ckpts}")
    print(f"[14 trainer] fit {TRAINER_EPOCHS} epochs, PoolResnet-128x10 480px grid 10 b8 bf16 "
          f"SAM+Adam, rotation on the card, {n_train} train / {n_val} val synthetic images: "
          f"train {out['train']}, val {out['val']}; params moved up to {moved:.3g}; launches "
          f"{fit} ({steps} steps, {TRAINER_EPOCHS} metrics steps, {TRAINER_EPOCHS * val_batches} "
          f"val batches); {len(lines)} log lines, checkpoints {ckpts}")

    # resume in a new Trainer from other params: bit-equal state, one epoch more
    train, val = trainer_loaders(root, shuffle=True)
    resumed = Trainer(trainer_module(SEED + 1), tcfg, train, val, run_name="smoke", device="cuda")
    check(resumed.maybe_resume() and resumed.epoch == TRAINER_EPOCHS,
          "maybe_resume found no checkpoint")
    check(resumed.state.step == trainer.state.step, "resumed step")
    for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
        check(torch.equal(p, q), "resumed params differ from the saved ones")
        sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
              "resumed Adam state differs from the saved one")
    more = resumed.fit(TRAINER_EPOCHS + 1)
    check(resumed.state.step == steps + len(train), "the resumed epoch's steps")
    check(all(np.isfinite(v) for split in more.values() for v in split.values()),
          f"non-finite metrics after resume {more}")
    print(f"[14 trainer] resumed at step {trainer.state.step}: params, Adam moments and step "
          f"bit-equal to the saved ones; one more epoch: train loss {more['train']['loss']:.4f}, "
          f"val loss {more['val']['loss']:.4f}")

    # ResidentDriver against StreamedDriver, float32, deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for resident in (False, True):
            train, val = trainer_loaders(root, shuffle=False)
            cfg = dataclasses.replace(tcfg, device_data=resident, rotate_device=False,
                                      checkpoint_dir=str(tmp / f"ckpt_{resident}"),
                                      log_path=str(tmp / f"logs_{resident}" / "out.log"))
            t = Trainer(trainer_module(SEED, dtype=None), cfg, train, val, augment=False,
                        run_name="det", device="cuda")
            runs[resident] = (t, t.fit())
    finally:
        torch.use_deterministic_algorithms(False)
    (ts, streamed), (tr, resident) = runs[False], runs[True]
    check(type(tr.driver).__name__ == "ResidentDriver", "device_data takes ResidentDriver")
    check(streamed == resident, f"epoch metrics differ: streamed {streamed}, resident {resident}")
    for p, q in zip(ts.state.module.parameters(), tr.state.module.parameters()):
        check(torch.equal(p, q), "resident params differ from streamed")
    print(f"[14 trainer] resident = streamed, float32, shuffle and augmentation off, "
          f"deterministic algorithms: epoch metrics and params bit-equal "
          f"(train loss {streamed['train']['loss']:.6f}, val loss {streamed['val']['loss']:.6f})")

    # run_validation_epoch on the saved checkpoint, with AP
    ckpt = latest_checkpoint(tmp / "ckpt" / "smoke")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--model", "poolresnet", "--checkpoint", str(ckpt),
            "--patches", "10", "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    check(set(val_out) == {"loss", "iou", "recall", "precision", "f1", "AP@0.5"}
          and all(np.isfinite(v) for v in val_out.values()), f"run_validation_epoch {val_out}")
    print(f"[14 trainer] run_validation_epoch --with-ap on {ckpt.name}: {val_out}")

    # the bench's measuring functions, short loops
    train_iters, infer_iters, latency_iters = BENCH_LOOPS
    line = fbench.run("cuda", rotate_device=True, train_iters=train_iters,
                      infer_iters=infer_iters, latency_iters=latency_iters, reps=1)
    want = bench_py_keys()
    check(want <= set(line), f"bench keys {sorted(line)} lack {sorted(want - set(line))}")
    numbers = [v for k, v in line.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    numbers += [x for v in line.values() if isinstance(v, list) for x in v]
    check(all(np.isfinite(numbers)) and line["train_mfu"] > 0, f"bench line {line}")
    print(f"[14 trainer] fdtpu_torch.bench, loops {BENCH_LOOPS}, reps 1: {json.dumps(line)}")
    return counts_since(phase_start)


# -- the SSD path ------------------------------------------------------------------


def ssd_module(cfg: SSDConfig, device, compute_dtype=None, seed: int = SEED):
    return build_model("ssd", cfg, device, torch.Generator().manual_seed(seed),
                       compute_dtype=compute_dtype)


def ssd_batch(b, size, device):
    """Random u8 frames with ``SSD_FACES`` boxes each, in a padded (B, 8, 5)
    box array."""
    rng = np.random.default_rng(SEED + 13)
    images = rng.integers(0, 255, size=(b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 8, 5), dtype=np.float32)
    boxes[:, :SSD_FACES, 0] = 1.0
    boxes[:, :SSD_FACES, 1:3] = rng.uniform(0, size - 100, (b, SSD_FACES, 2)).round()
    boxes[:, :SSD_FACES, 3:5] = rng.uniform(20, 100, (b, SSD_FACES, 2)).round()
    masks = np.tile(np.arange(8) < SSD_FACES, (b, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (images, boxes, masks))


def phase_ssd_forward_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, gpu = ssd_module(SSD_CFG, "cpu").eval(), ssd_module(SSD_CFG, "cuda").eval()
    u8 = np.random.default_rng(SEED + 14).integers(0, 256, size=(2, 480, 480, 3), dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    check(got.shape == (2, 4774, 5), f"SSD forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite SSD forward output")
    err = (got - want).abs().max().item()
    check(err <= FORWARD_ATOL, f"card SSD forward differs from CPU by {err} > {FORWARD_ATOL}")
    above = (want[..., 0] > 0.5).float().mean().item()
    print(f"[15 ssd forward f32] SSD-16 480px B=2 (4774 priors), card vs CPU max abs err "
          f"{err:.3g} (atol {FORWARD_ATOL}); {above:.0%} of the scores above 0.5")


def phase_ssd_serving():
    """bf16 Detectors on the card: ``predict`` on three odd-sized frames,
    then the batch path at b24/480 (N = 4,774, K1 in shared memory) and
    b8/640 (N = 8,500, K1 on global scratch), boxes equal to the plain
    version's on the same forward output."""
    det = Detector(ssd_module(SSD_CFG, "cuda"))
    det640 = Detector(ssd_module(SSD_640, "cuda"))
    rng = np.random.default_rng(SEED + 15)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    b24 = torch.from_numpy(rng.integers(0, 256, size=(SSD_BATCH, 480, 480, 3), dtype=np.uint8)).cuda()
    b8 = torch.from_numpy(rng.integers(0, 256, size=(SSD_640_BATCH, 640, 640, 3),
                                       dtype=np.uint8)).cuda()

    knms.decode_filter_nms_batch.launches = 0
    preds = [det.predict(f) for f in frames]
    out24 = det.apply(b24.float() / 255.0)
    boxes24, mask24 = det.non_max_suppression(out24)
    out8 = det640.apply(b8.float() / 255.0)
    boxes8, mask8 = det640.non_max_suppression(out8)
    torch.cuda.synchronize()
    launches = knms.decode_filter_nms_batch.launches
    check(launches == len(frames) + 2, f"K1 launched {launches} times, want {len(frames) + 2}")

    counts = [int(check_boxes(b, m, 128, 0.5, "SSD predict")) for _, b, m in preds]
    check(out24.shape == (SSD_BATCH, 4774, 5) and out8.shape == (SSD_640_BATCH, 8500, 5),
          f"SSD forward shapes {tuple(out24.shape)}, {tuple(out8.shape)}")
    check(8500 > knms.max_candidates(0), "N = 8,500 does not reach K1's global-scratch path")
    kept = {}
    for name, out, boxes, mask, size in (("b24/480", out24, boxes24, mask24, 480),
                                         ("b8/640", out8, boxes8, mask8, 640)):
        check(bool(torch.isfinite(out).all()), f"non-finite SSD forward at {name}")
        kept[name] = check_boxes(boxes, mask, 128, 0.5, f"SSD {name}")
        tables = knms.ssd_output_tables_on(out.shape[1], (size, size), out.device)
        wb, wm = knms.decode_filter_nms_reference(out, tables, 0.5, 0.5, 128)
        check(torch.equal(mask, wm) and torch.equal(boxes, wb), f"SSD {name} boxes differ from plain")
    eligible = (out24[..., 0] > 0.5).sum(-1).float().mean().item()
    print(f"[15 ssd serving] bf16 SSD-16 Detectors on the card: predict x3 at 480px -> {counts} "
          f"boxes; b24 at 480px (N 4774, {eligible:.0f} eligible an image) -> "
          f"{int(kept['b24/480'].sum())} boxes; b8 at 640px (N 8500, global scratch) -> "
          f"{int(kept['b8/640'].sum())} boxes; K1 launches {launches}; both batch decodes equal "
          f"plain")
    return launches, {"det": det, "det640": det640, "b24": b24, "out24": out24, "out8": out8}


def phase_ssd_train_f32() -> None:
    """One float32 SAM + SGD step of SSD-16 at 480 px, B=2, card against
    CPU, augmentation and dropout off, at phase 8's tolerances; and how many
    of the first forward's mined priors differ between the devices."""

    def module(dev):
        return SSD(SSD_CFG.filters, SSD_CFG.input_shape, SSD_CFG.patch_sizes, dropout=0.0,
                   generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    mined = {}
    for dev in ("cpu", "cuda"):
        net = module(dev)
        images, boxes, masks = ssd_batch(2, 480, dev)
        with torch.no_grad():
            out = net(images.float() / 255.0)
            enc, _ = tstep._encode_targets(net, boxes, masks, (480, 480))
        mined[dev] = hard_negative_mining(-torch.log(out[..., 0].clamp(1e-7, 1.0)),
                                          enc[..., 0], 10).cpu()
    line = f32_step_card_vs_cpu(module, lambda dev: ssd_batch(2, 480, dev), "SSD")
    flips = int((mined["cpu"] != mined["cuda"]).sum())
    print(f"[15 ssd train f32] SAM + SGD step, SSD-16 480px B=2, card vs CPU: {line}; mined "
          f"priors that differ {flips} of {int(mined['cpu'].sum())}")


def phase_ssd_train_path():
    """Five bf16 SAM + Adam steps of SSD-16 at 480 px, b24, augmentation
    off (``train_model_ssd``'s default), the last with train metrics."""
    module = ssd_module(SSD_CFG, "cuda", compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(seed=SEED)
    state = create_train_state(module, tcfg, 100)
    step = make_train_step(module, tcfg, augment=False)
    metrics_step = make_train_step(module, tcfg, augment=False, compute_metrics=True)
    batch = ssd_batch(SSD_BATCH, 480, "cuda")
    before = [p.detach().clone() for p in module.parameters()]

    knms.decode_filter_nms_batch.launches = 0
    scalars = []
    for i in range(TRAIN_STEPS):
        state, sc = (metrics_step if i == TRAIN_STEPS - 1 else step)(state, *batch)
        scalars.append(sc)
    torch.cuda.synchronize()
    launches = knms.decode_filter_nms_batch.launches
    check(launches == 1, f"K1 launched {launches} times in {TRAIN_STEPS} SSD steps, want 1")
    check(all(np.isfinite(v.item()) for sc in scalars for v in sc.values()),
          "non-finite SSD train scalars")
    moved = max((p - q).abs().max().item() for p, q in zip(module.parameters(), before))
    check(moved > 0, "SSD params did not move")
    check(all(p.dtype == torch.float32 for p in module.parameters()), "SSD params left float32")
    last = scalars[-1]
    print(f"[15 ssd train path] SSD-16 b24 480px bf16 SAM+Adam, {TRAIN_STEPS} steps: losses "
          f"{[round(sc['loss'].item(), 3) for sc in scalars]}, grad norm "
          f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f} recall "
          f"{last['recall'].item():.4f} precision {last['precision'].item():.4f}; params moved "
          f"up to {moved:.3g}; K1 launches {launches}")
    return launches, (state, step, batch)


def phase_ssd_trainer(tmp) -> int:
    """``train_model_ssd``'s Trainer (its defaults: SSD-16, 480 px, b24,
    SAM + Adam, quarter-epochs) for two quarter-epochs on synthetic data,
    a resume in a new Trainer, and ``run_validation_epoch --model ssd
    --with-ap`` on the checkpoint. Returns K1's launches."""
    from pathlib import Path

    tmp = Path(tmp) / "ssd"
    n_train, n_val = SSD_TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED, max_faces=4)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1, max_faces=4)
    flags = ["--data-dir", str(root), "--epochs", str(TRAINER_EPOCHS), "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(tmp)  # checkpoints/, logs/ and imgs/ go here
    try:
        knms.decode_filter_nms_batch.launches = 0
        trainer = train_model_ssd.build_trainer(train_model_ssd.parse_args(flags))
        out = trainer.fit()
        torch.cuda.synchronize()
        fit_launches = knms.decode_filter_nms_batch.launches
        steps = TRAINER_EPOCHS * len(trainer.train_loader)
        check(trainer.state.step == steps, f"SSD Trainer took {trainer.state.step} steps, want {steps}")
        check(all(np.isfinite(v) for split in out.values() for v in split.values()),
              f"non-finite SSD epoch metrics {out}")
        # each quarter-epoch: the first-batch drawing's eval, the metrics step, each val batch
        want = TRAINER_EPOCHS * (2 + len(trainer.val_loader))
        check(fit_launches == want, f"K1 launched {fit_launches} times in fit, want {want}")
        ckpt = latest_checkpoint(tmp / "checkpoints" / trainer.run_name)
        check(ckpt is not None and ckpt.name == f"step_{steps:08d}.pt", f"checkpoint {ckpt}")

        resumed = train_model_ssd.build_trainer(train_model_ssd.parse_args([*flags, "--seed", "1"]))
        check(resumed.maybe_resume() and resumed.epoch == TRAINER_EPOCHS
              and resumed.state.step == steps, "the SSD resume's epoch or step")
        for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
            check(torch.equal(p, q), "resumed SSD params differ from the saved ones")
            sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
            check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                  "resumed SSD Adam state differs from the saved one")

        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--model", "ssd", "--checkpoint", str(ckpt),
            "--batch-size", str(SSD_BATCH), "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    launches = knms.decode_filter_nms_batch.launches
    check(all(np.isfinite(v) for v in val_out.values()) and 0.0 <= val_out["AP@0.5"] <= 1.0,
          f"run_validation_epoch --model ssd {val_out}")
    print(f"[15 ssd trainer] train_model_ssd's Trainer, {TRAINER_EPOCHS} quarter-epochs of "
          f"{len(trainer.train_loader)} steps (SSD-16 480px b24 bf16 SAM+Adam, {n_train} train / "
          f"{n_val} val synthetic images): train {out['train']}, val {out['val']}; K1 launches "
          f"{fit_launches}; resume: params, Adam moments and step bit-equal; "
          f"run_validation_epoch --model ssd --with-ap on {ckpt.name}: {val_out}")
    return launches


def phase_ssd_timings(card, serving, train) -> list[dict]:
    """CUDA events after warmup: the SSD train step, forward + decode at
    b24/480 and the b1 ``predict``; then K1 alone (``device_ms``) on the
    SSD's own maps against its plain version."""
    state, step, batch = train
    ms = step_ms(state, step, batch, 20)
    print(f"[15 time] SSD-16 train b24 480px bf16 SAM+Adam: {ms:.3f} ms/step "
          f"({SSD_BATCH * 1e3 / ms:.1f} img/s) [{card}]")
    det, b24 = serving["det"], serving["b24"]
    ms = event_ms(lambda: det.non_max_suppression(det.apply(b24.float() / 255.0)), 20)
    print(f"[15 time] SSD-16 b24 480px bf16 forward + decode: {ms:.3f} ms/batch, "
          f"{SSD_BATCH * 1e3 / ms:.1f} img/s [{card}]")
    frame = np.random.default_rng(SEED + 16).integers(0, 256, size=(480, 480, 3), dtype=np.uint8)
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        det.predict(frame)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[15 time] SSD-16 b1 predict 480px bf16 (H2D + /255 + forward + decode): median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms over {len(lat)} [{card}]")

    rows = []
    out24, out8 = serving["out24"], serving["out8"]
    for vals, size in ((out24, 480), (out24[:1].contiguous(), 480), (out8, 640)):
        b, n, cap = vals.shape[0], vals.shape[1], 128
        tables = knms.ssd_output_tables_on(n, (size, size), vals.device)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap], "maps": "SSD-16 bf16 output, random weights",
               "path": "scratch" if n > knms.max_candidates(0) else "shared"}
        row["ms"], row["plain_ms"], runs = turns(kern, plain, 20, 2)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        print(f"[15 time] decode_filter_nms B={b} N={n} cap={cap} on SSD maps ({row['path']}): "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({runs}); bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def phase_ssd(card, tmp):
    """15: the SSD path. Returns K1's launches on it and its timed rows."""
    phase_ssd_forward_f32()
    serving_launches, serving = phase_ssd_serving()
    phase_ssd_train_f32()
    train_launches, train = phase_ssd_train_path()
    trainer_launches = phase_ssd_trainer(tmp)
    rows = phase_ssd_timings(card, serving, train)
    return serving_launches + train_launches + trainer_launches, rows


# -- the rest of the zoo -------------------------------------------------------------


def zoo_module(name: str, device, compute_dtype=None, seed: int = SEED):
    return build_model(name, ZOO[name], device, torch.Generator().manual_seed(seed),
                       compute_dtype=compute_dtype)


class Holder(torch.nn.Module):
    """A scriptable module that only carries named tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def mobilenetv3_reference_archive(path, seed: int) -> None:
    """A TorchScript archive in the reference's layout (timm's stage names,
    ``num_batches_tracked`` included) of a MobileNetV3 from ``seed`` with
    random BatchNorm params and running statistics (means in [-0.5, 0.5],
    variances in [0.5, 1.5])."""
    port = MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), ZOO_SIZE // 32,
                               generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    # timm's block 0 is a DepthwiseSeparableConv: its conv_pw is the projection
    to_ref = {v: k for k, v in torch_import.mobilenetv3_prefixes(
        {"feature_extractor.3.0.0.conv_pw.weight": None}).items()}
    root = Holder()
    for name, t in port.state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        t = t.clone()
        if leaf == "running_mean" or (leaf == "bias" and t.dim() == 1):
            t.uniform_(-0.5, 0.5, generator=gen)
        elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
            t.uniform_(0.5, 1.5, generator=gen)
        mod = root
        for part in to_ref[prefix].split("."):
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        if leaf.startswith("running"):
            mod.register_buffer(leaf, t)
            mod.register_buffer("num_batches_tracked", torch.tensor(1000))
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    torch.jit.script(root).save(str(path))


def phase_zoo_forward_f32(tmp) -> None:
    """Each family's float32 eval forward at 480 px, B=2, card against CPU,
    TF32 off; MobileNetV3's weights and running statistics imported from a
    reference-layout TorchScript archive through ``compat.torch_import``."""
    from pathlib import Path

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    archive = Path(tmp) / "mobilenetv3_reference.pth"
    mobilenetv3_reference_archive(archive, SEED + 20)
    u8 = np.random.default_rng(SEED + 21).integers(0, 256, size=(2, ZOO_SIZE, ZOO_SIZE, 3),
                                                   dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    for name in ZOO:
        cpu, gpu = zoo_module(name, "cpu"), zoo_module(name, "cuda")
        if name == "mobilenetv3":
            for m in (cpu, gpu):
                torch_import.load_torchscript_weights(archive, m)
            check(not torch.equal(gpu.bn_576.running_var.cpu(), torch.ones(576)),
                  "the archive's running statistics did not load")
        with torch.inference_mode():
            want = cpu(x)
            got = gpu(x.cuda()).cpu()
        s = cpu.grid_size()
        check(got.shape == (2, s, s, 5), f"{name} forward shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"non-finite {name} forward output")
        err = (got - want).abs().max().item()
        check(err <= FORWARD_ATOL, f"card {name} forward differs from CPU by {err}")
        live = ((want > 0.01) & (want < 0.99)).float().mean().item()
        src = " (imported archive)" if has_batch_stats(cpu) else ""
        print(f"[16 zoo forward f32] {name} {ZOO_SIZE}px grid {s} B=2{src}, card vs CPU max abs "
              f"err {err:.3g} (atol {FORWARD_ATOL}); {live:.0%} of outputs in (0.01, 0.99)")


def phase_zoo_train_f32() -> None:
    """One float32 SAM + SGD step of MobileNetV3 at 480 px, B=2, card
    against CPU, at phase 8's tolerances, BatchNorm statistics included."""

    def module(dev):
        return MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), 15,
                                   generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    line = f32_step_card_vs_cpu(module, lambda dev: bench_like_batch(2, ZOO_SIZE, dev),
                                "MobileNetV3", noise=("bn3.bias",))
    print(f"[16 zoo train f32] SAM + SGD step, MobileNetV3-Small {ZOO_SIZE}px B=2, card vs CPU: "
          f"{line}")


def phase_zoo_serving():
    """bf16 Detectors of each family on the card: ``predict`` on three
    odd-sized frames, then the batch path at b64/480; K1 once a call, its
    boxes equal to the plain version's on the same forward output."""
    rng = np.random.default_rng(SEED + 22)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    batch = torch.from_numpy(rng.integers(0, 256, size=(ZOO_SERVE_BATCH, ZOO_SIZE, ZOO_SIZE, 3),
                                          dtype=np.uint8)).cuda()
    dets = {name: Detector(zoo_module(name, "cuda")) for name in ZOO}
    knms.decode_filter_nms_batch.launches = 0
    outs = {}
    for name, det in dets.items():
        start = knms.decode_filter_nms_batch.launches
        preds = [det.predict(f) for f in frames]
        out = det.apply(batch.float() / 255.0)
        boxes, mask = det.non_max_suppression(out)
        torch.cuda.synchronize()
        calls = knms.decode_filter_nms_batch.launches - start
        check(calls == len(frames) + 1, f"{name}: K1 launched {calls} times a frame and a batch")
        counts = [int(check_boxes(b, m, 128, 0.5, f"{name} predict")) for _, b, m in preds]
        s = det.module.grid_size()
        check(out.shape == (ZOO_SERVE_BATCH, s, s, 5) and bool(torch.isfinite(out).all()),
              f"{name} batch forward")
        kept = check_boxes(boxes, mask, 128, 0.5, f"{name} batch")
        wb, wm = knms.decode_filter_nms_reference(
            out.reshape(ZOO_SERVE_BATCH, -1, 5),
            knms.grid_tables_on(s, (ZOO_SIZE, ZOO_SIZE), out.device), 0.5, 0.5, 128)
        check(torch.equal(mask, wm) and torch.equal(boxes, wb), f"{name} boxes differ from plain")
        outs[name] = out
        print(f"[16 zoo serving] bf16 {name} Detector on the card: predict x3 -> {counts} boxes; "
              f"b{ZOO_SERVE_BATCH} at {ZOO_SIZE}px grid {s} (N {s * s}) -> {int(kept.sum())} "
              f"boxes; K1 launches {calls}; batch decode equals plain")
    return knms.decode_filter_nms_batch.launches, dets, batch, outs


def phase_zoo_train():
    """bf16 SAM + Adam steps at b8/480 with rotation on the card: five of
    MobileNetV3, two each of Resnet and SeparableCNN, the last of each with
    train metrics. Returns the kernels' launches and the runs."""
    runs = {}
    for name in ZOO:
        module = zoo_module(name, "cuda", compute_dtype=torch.bfloat16)
        tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED)
        state = create_train_state(module, tcfg, 100)
        steps = (make_train_step(module, tcfg), make_train_step(module, tcfg, compute_metrics=True))
        runs[name] = (state, steps, bench_like_batch(ZOO_TRAIN_BATCH, ZOO_SIZE, "cuda"))
    before = {name: {k: v.detach().clone() for k, v in st.module.state_dict().items()}
              for name, (st, _, _) in runs.items()}

    krot.shear_rows.launches = krot.shear_cols.launches = 0
    knms.decode_filter_nms_batch.launches = 0
    scalars = {}
    for name, (state, (step, metrics_step), batch) in runs.items():
        n = ZOO_TRAIN_STEPS[name]
        for i in range(n):
            state, sc = (metrics_step if i == n - 1 else step)(state, *batch)
            scalars.setdefault(name, []).append(sc)
    torch.cuda.synchronize()
    launches = kernel_counts()
    calls = sum(ZOO_TRAIN_STEPS.values())  # one rotate_batch a step
    check(launches["shear_rows"] == 2 * calls and launches["shear_cols"] == calls,
          f"zoo shear launches {launches}, want {2 * calls} and {calls}")
    check(launches["decode_filter_nms"] == len(runs), f"zoo K1 launches {launches}")
    for name, (state, _, _) in runs.items():
        check(state.step == ZOO_TRAIN_STEPS[name], f"{name} stepped {state.step} times")
        check(all(np.isfinite(v.item()) for sc in scalars[name] for v in sc.values()),
              f"{name} non-finite scalars")
        after = state.module.state_dict()
        moved = max((after[k] - v).abs().max().item() for k, v in before[name].items()
                    if "running" not in k)
        stats = [k for k in after if "running" in k]
        check(moved > 0, f"{name} params did not move")
        check(all(not torch.equal(after[k], before[name][k]) for k in stats),
              f"{name} BatchNorm statistics did not move")
        check(all(p.dtype == torch.float32 for p in state.module.parameters()),
              f"{name} params left float32")
        last = scalars[name][-1]
        print(f"[16 zoo train] {name} b{ZOO_TRAIN_BATCH} {ZOO_SIZE}px bf16 SAM+Adam rotation on, "
              f"{ZOO_TRAIN_STEPS[name]} steps: losses "
              f"{[round(sc['loss'].item(), 3) for sc in scalars[name]]}, grad norm "
              f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f}; params moved "
              f"up to {moved:.3g}; {len(stats)} BatchNorm statistics, all moved")
    print(f"[16 zoo train] launches: shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']} ({calls} rotate_batch calls), decode_filter_nms "
          f"{launches['decode_filter_nms']} ({len(runs)} metrics steps)")
    return launches, runs


def phase_zoo_trainer(tmp) -> dict:
    """``train_model --model mobilenetv3 --rotate-device`` for one epoch on
    synthetic data (its defaults otherwise: 480 px, b8, bf16, SAM + Adam),
    a resume in a new Trainer from another seed (params, BatchNorm
    statistics, Adam's state and the step bit-equal), and
    ``run_validation_epoch`` (MobileNetV3, its default) on the checkpoint.
    Returns the kernels' launches."""
    from pathlib import Path

    tmp = Path(tmp) / "zoo"
    n_train, n_val = ZOO_TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    flags = ["--data-dir", str(root), "--model", "mobilenetv3", "--input", str(ZOO_SIZE),
             "--patches", str(ZOO_SIZE // 32), "--epochs", "1", "--rotate-device",
             "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(tmp)  # checkpoints/, logs/ and imgs/ go here
    try:
        start = kernel_counts()
        trainer = train_model.build_trainer(train_model.parse_args(flags))
        out = trainer.fit()
        torch.cuda.synchronize()
        fit = counts_since(start)
        steps = len(trainer.train_loader)
        check(trainer.state.step == steps, f"MobileNetV3 Trainer took {trainer.state.step} steps")
        check(all(np.isfinite(v) for split in out.values() for v in split.values()),
              f"non-finite MobileNetV3 epoch metrics {out}")
        # the first batch's drawing, the metrics step, each val batch
        want = 2 + len(trainer.val_loader)
        check(fit["decode_filter_nms"] == want and fit["shear_rows"] == 2 * steps
              and fit["shear_cols"] == steps, f"MobileNetV3 Trainer launches {fit}")
        ckpt = latest_checkpoint(tmp / "checkpoints" / trainer.run_name)
        check(ckpt is not None and ckpt.name == f"step_{steps:08d}.pt", f"checkpoint {ckpt}")

        resumed = train_model.build_trainer(train_model.parse_args([*flags, "--seed", "1"]))
        check(resumed.maybe_resume() and resumed.state.step == steps, "the MobileNetV3 resume")
        saved, now = trainer.state.module.state_dict(), resumed.state.module.state_dict()
        check(saved.keys() == now.keys() and all(torch.equal(saved[k], now[k]) for k in saved),
              "resumed MobileNetV3 params or BatchNorm statistics differ from the saved ones")
        for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
            sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
            check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                  "resumed MobileNetV3 Adam state differs from the saved one")
        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--checkpoint", str(ckpt), "--input", str(ZOO_SIZE),
            "--patches", str(ZOO_SIZE // 32), "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    check(set(val_out) == {"loss", "iou", "recall", "precision", "f1", "AP@0.5"}
          and all(np.isfinite(v) for v in val_out.values()), f"run_validation_epoch {val_out}")
    print(f"[16 zoo trainer] train_model --model mobilenetv3 --rotate-device, one epoch of "
          f"{steps} steps ({ZOO_SIZE}px b8 bf16 SAM+Adam, {n_train} train / {n_val} val synthetic "
          f"images): train {out['train']}, val {out['val']}; launches {fit}; resume: params, "
          f"BatchNorm statistics, Adam moments and step bit-equal; run_validation_epoch "
          f"(--model mobilenetv3 by default) --with-ap on {ckpt.name}: {val_out}")
    return counts_since(start)


def phase_zoo_timings(card, serving, train) -> None:
    """Per family, CUDA events after warmup: the b1 ``predict`` latency
    (median and min over 50 calls), forward + decode at b64/480, and the
    b8/480 train step, three runs of 10 (the step is host-bound: the runs'
    range is given)."""
    dets, batch, _ = serving
    frame = np.random.default_rng(SEED + 23).integers(0, 256, size=(ZOO_SIZE, ZOO_SIZE, 3),
                                                      dtype=np.uint8)
    for name, det in dets.items():
        lat = []
        for i in range(60):
            t0 = time.perf_counter()
            det.predict(frame)
            torch.cuda.synchronize()
            if i >= 10:
                lat.append((time.perf_counter() - t0) * 1e3)
        ms = event_ms(lambda: det.non_max_suppression(det.apply(batch.float() / 255.0)), 10)
        state, (step, _), tbatch = train[name]
        runs = [step_ms(state, step, tbatch, 10) for _ in range(3)]
        print(f"[16 time] {name}: b1 predict {ZOO_SIZE}px bf16 median "
              f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms over {len(lat)}; "
              f"b{ZOO_SERVE_BATCH} {ZOO_SIZE}px forward + decode "
              f"{ms:.3f} ms/batch ({ZOO_SERVE_BATCH * 1e3 / ms:.1f} img/s); train "
              f"b{ZOO_TRAIN_BATCH} "
              f"{ZOO_SIZE}px bf16 SAM+Adam rotation on {min(runs):.3f}-{max(runs):.3f} ms/step "
              f"({ZOO_TRAIN_BATCH * 1e3 / max(runs):.1f}-{ZOO_TRAIN_BATCH * 1e3 / min(runs):.1f} "
              f"img/s) [{card}]")


def phase_zoo(card, tmp) -> dict:
    """16: the rest of the zoo. Returns the kernels' launches on its paths."""
    t0 = time.perf_counter()
    phase_zoo_forward_f32(tmp)
    phase_zoo_train_f32()
    serve_k1, *serving = phase_zoo_serving()
    train_launches, train = phase_zoo_train()
    trainer_launches = phase_zoo_trainer(tmp)
    phase_zoo_timings(card, serving, train)
    launches = {k: train_launches[k] + trainer_launches[k] for k in train_launches}
    launches["decode_filter_nms"] += serve_k1
    print(f"[16 zoo] launches on the zoo's paths {launches}; phase 16 took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def kernel_times_only() -> None:
    """``--kernel-times``: the card, the build, and K1-K4's device times
    (no plain versions) as one JSON line; ``python -m
    fdtpu_torch.compare_parent`` runs this in turns on two trees."""
    card, _ = phase_card()
    phase_build()
    print(json.dumps({"kernel_times": {"card": card, "decode_filter_nms": nms_times(card, False),
                                       "shears": shear_times(card, False)}}))


def main() -> None:
    card, name = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    phase_forward_f32()
    launches, det480, det320, batch = phase_main_path()
    nms_rows = phase_timings(card, det480, det320, batch)
    rot_worst = phase_rotate_vs_plain()
    phase_train_f32()
    train_launches, runs = phase_train_path()
    shear_rows = phase_train_timings(card, runs)
    del runs
    photo_worst = phase_photometric_vs_plain()
    phase_tail_vs_plain()
    tail_launches = phase_tail_path()
    photo_launches, train = phase_photometric_path()
    fused_times = phase_fused_timings(card, train)
    del train
    with tempfile.TemporaryDirectory() as tmp:
        trainer_launches = phase_trainer(tmp)
        ssd_launches, ssd_rows = phase_ssd(card, tmp)
        zoo_launches = phase_zoo(card, tmp)

    def entry(meta, launches, err, times, library_ms=None):
        ms, plain, bnd = times
        return {**meta, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                **bnd, "library_ms": library_ms}

    def row_times(row):
        return row["ms"], row["plain_ms"], {k: row[k] for k in ("bound_ms", "bound_by")}

    # K1 at b128/225 and the shears on the b128 exact-k planes head their
    # entries; every shape timed follows under "shapes"
    # (library_ms: F.grid_sample on the float32 rows only, see shear_times)
    kernels = [{**entry(KERNEL, launches + train_launches["decode_filter_nms"]
                        + trainer_launches["decode_filter_nms"] + ssd_launches
                        + zoo_launches["decode_filter_nms"], worst,
                        row_times(nms_rows[0])), "shapes": nms_rows + ssd_rows}]
    for kname, meta in SHEARS.items():
        rows = [r for r in shear_rows if r["name"].startswith(kname)]
        kernels.append({**entry({"name": kname, **meta},
                                train_launches[kname] + photo_launches[kname]
                                + trainer_launches[kname] + zoo_launches[kname], rot_worst,
                                row_times(rows[0]), rows[0]["library_ms"]), "shapes": rows})
    kernels.append(entry(PHOTOMETRIC, photo_launches["photometric"], photo_worst,
                         fused_times["photometric"]))
    kernels.append({**entry(RESIDUAL_TAIL, tail_launches, 0.0, fused_times["residual_tail"]),
                    "shapes": fused_times["residual_tail_shapes"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--kernel-times"]:
        kernel_times_only()
    else:
        main()
