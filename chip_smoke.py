"""Smoke test of the PyTorch + CUDA port (fdtpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one printed line each (any failure raises, and the script exits
non-zero; without a CUDA card it fails at once and prints no result):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written kernel from the checkout's sources;
3. the decode+filter+NMS kernel against its plain PyTorch version on the
   card: B in {1, 8, 128}, N in {100, 225, 4774}, capacity in {64, 128},
   thresholds 0.5/0.5 and 0.7/0.01, random, saturated, tie and empty maps.
   Masks, scores and coordinates must be bit-equal;
4. the full-width float32 forward (PoolResnet-128, 10 blocks, 480 px, B=2,
   TF32 off) on the card against the same model on the CPU, atol 1e-4;
5. the serving path: a bfloat16 Detector on the card, ``predict`` on three
   odd-sized u8 frames at DetectorConfig() (480 px, grid 10), then the batch
   path at the bench shape (320 px, grid 15, B=128, capacity 64). The
   kernel's launch count must rise once per call, and the batch path's boxes
   must equal the plain version's on the same forward output;
6. timings with CUDA events after warmup: kernel against plain version at
   three shapes, the b128 forward + decode, the b1 predict latency.

The line before the last is a JSON object with the kernel's launches, error
and times; the last is ``{"ok": true, "device": {...}}``. Weights are random,
drawn from a fixed seed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from fdtpu_torch.kernels import build
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.models import Detector, build_model
from fdtpu_torch.utils.config import DetectorConfig

SEED = 0
FORWARD_ATOL = 1e-4  # float32 card vs CPU: summation order only, TF32 off
BENCH_CFG = DetectorConfig(input_shape=(320, 320), num_patches=15, nms_capacity=64)
KERNEL = {
    "name": "decode_filter_nms",
    "route": "cuda",
    "source": "fdtpu_torch/kernels/csrc/decode_filter_nms.cu",
    "replaces": "fdtpu/kernels/nms_pallas.py:197",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# -- inputs ----------------------------------------------------------------------


def candidates(rng, b, n, case):
    """(B, N, 5) rows [conf, x, y, w, h] in the model's [0, 1] units."""
    v = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
    if case == "saturated":  # small, mostly disjoint boxes: > capacity survive
        v[..., 3:] = rng.uniform(0.002, 0.03, size=(b, n, 2))
    elif case == "tie":  # three score levels, many exact ties
        v[..., 0] = rng.choice(np.float32([0.3, 0.75, 0.9]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "empty":
        v[:] = 0.0
    else:  # random
        v[..., 3:] *= 0.3
    return torch.from_numpy(v).cuda()


def tables_for(n):
    if n == 4774:  # SSD model output, 480 px
        cols = knms.ssd_output_decode_tables(n, (480, 480))
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


# -- phases ----------------------------------------------------------------------


def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    card = card_line()
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
    for b in (1, 8, 128):
        for n in (100, 225, 4774):
            tables = tables_for(n)
            for cap in (64, 128):
                for case in ("random", "saturated", "tie", "empty"):
                    vals = candidates(rng, b, n, case)
                    for prob, iou in ((0.5, 0.5), (0.7, 0.01)):
                        gb, gm = knms.decode_filter_nms_batch(vals, tables, prob, iou, cap)
                        wb, wm = knms.decode_filter_nms_reference(vals, tables, prob, iou, cap)
                        torch.cuda.synchronize()
                        err = (gb - wb).abs().max().item()
                        worst = max(worst, err)
                        runs += 1
                        where = f"B={b} N={n} cap={cap} {case} {prob}/{iou}"
                        check(torch.equal(gm, wm), f"masks differ at {where}")
                        check(torch.equal(gb, wb), f"boxes differ at {where} (max {err})")
                        if case == "saturated" and prob == 0.5 and n / 2 > 1.5 * cap:
                            check(bool(gm.all()), f"not saturated at {where}")
                        if case == "empty":
                            check(not gm.any(), f"boxes from an empty map at {where}")
    print(f"[3 kernel=plain] {runs} cases bit-equal (masks, scores, coordinates); "
          f"max |kernel - plain| = {worst}")
    return worst


def phase_forward_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig()
    cpu = build_model("poolresnet", cfg, generator=torch.Generator().manual_seed(SEED)).eval()
    gpu = build_model("poolresnet", cfg, generator=torch.Generator().manual_seed(SEED))
    gpu = gpu.cuda().eval()
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


def phase_timings(card, det480, det320, batch):
    rng = np.random.default_rng(SEED + 3)
    times = {}
    for b, n, cap in ((128, 225, 64), (1, 100, 128), (128, 4774, 128)):
        vals = candidates(rng, b, n, "random")
        tables = tables_for(n)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        # plain, kernel, kernel, plain: drift on the card hits both alike
        p1, k1, k2, p2 = (event_ms(f, 20) for f in (plain, kern, kern, plain))
        times[(b, n, cap)] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[6 time] decode_filter_nms B={b} N={n} cap={cap} random maps: kernel "
              f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms "
              f"(runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}) [{card}]")

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
    return times[(128, 225, 64)]


def main() -> None:
    card, name = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    phase_forward_f32()
    launches, det480, det320, batch = phase_main_path()
    kernel_ms, plain_ms = phase_timings(card, det480, det320, batch)
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
