"""The config-of-record training run on one card, with AP by epoch and the
decode kernel (K1) timed on the trained model's own val maps.

    python -m fdtpu_torch.config_of_record --epochs 40 \\
        [--train-images 2000 --val-images 500 --work build/config_of_record \\
         --out build/config_of_record/summary.json]
    python -m fdtpu_torch.config_of_record --model ssd --epochs 70 ...

1. ``make_synthetic_widerface`` writes the train and val splits (seeds 0
   and 1) under ``--work``;
2. ``python -m fdtpu_torch.train_model`` at its defaults (PoolResnet-128,
   10 blocks, 480 px, grid 10, b8, SAM + Adam, MultiStep at epoch 40, host
   rotation p = 0.2, bf16 compute) runs ``--epochs`` epochs there, a
   checkpoint each epoch; with ``--model ssd``, ``python -m
   fdtpu_torch.train_model_ssd`` at its defaults (SSD-16, 480 px, 4,774
   priors, b24, SAM + Adam, augmentation off) runs ``--epochs``
   quarter-epochs (``--bg-push`` passes its loss option on). Each epoch's
   train time comes from its log records' times (the train record of
   epoch e minus the val record of e - 1, the first from the start of
   ``fit``);
3. ``run_validation_epoch --with-ap`` (the reference's thresholds, 0.5 and
   0.01; ``--model ssd`` for the SSD) reads each epoch's checkpoint: AP@0.5
   by epoch;
4. the best epoch's model runs its eval forward over the val split, and K1
   decodes those maps (b8, N = 100 for PoolResnet; b24, N = 4,774 for the
   SSD; capacity 64, thresholds 0.5 / 0.5, as the Trainer's eval step
   calls it) on the card alone (launches queued behind a sleep, as
   ``chip_smoke.device_ms``), in turns with K1 on random maps of the same
   shape; the maps' eligible and kept counts say how sparse they are.

Prints one JSON summary and writes it to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import numpy as np
import torch

from fdtpu_torch import run_validation_epoch, train_model, train_model_ssd
from fdtpu_torch.bench_pool_fusion import card_line
from fdtpu_torch.data import BatchLoader, DevicePrefetcher, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import DTYPES, build_model
from fdtpu_torch.train.checkpoint import restore_variables
from fdtpu_torch.train.step import _decode_predictions, _image_size
from fdtpu_torch.utils.config import DetectorConfig, SSDConfig

NMS = (0.5, 0.5, 64)  # the Trainer's eval decode


class Run(NamedTuple):
    """One family's config-of-record run."""

    entry: ModuleType  # its training entry point
    config: DetectorConfig | SSDConfig
    batch: int
    epoch_fraction: int
    max_faces: int  # the loader's crowding filter
    val_flags: list[str]  # run_validation_epoch's flags for it


RUNS = {
    "poolresnet": Run(train_model, DetectorConfig(), 8, 1, 3,
                      ["--model", "poolresnet", "--patches", "10"]),
    "ssd": Run(train_model_ssd, SSDConfig(), 24, 4, 120, ["--model", "ssd"]),
}


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``: the calls queue behind a
    sleep that outlasts their launches on the host, so CUDA events around
    them time the card alone (``chip_smoke.device_ms``'s method; that
    script keeps its own copy, as it times older trees of the package
    too)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_s = 20_000_000 / (a.elapsed_time(b) / 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_s * min(1.5 * host_s * iters + 1e-3, 0.5)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def epoch_train_seconds(jsonl: Path, t_start: float) -> list[float]:
    """Each epoch's train time from the log's records: its train record
    minus the previous val record (the first from ``t_start``)."""
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    out, prev = [], t_start
    for r in records:
        if r["split"] == "training":
            out.append(r["time"] - prev)
        else:
            prev = r["time"]
    return out


def val_maps(ckpt: Path, root: Path, model: str):
    """The trained module and its raw maps over the val split, as the eval
    step's forward makes them (float32 params, bf16 compute)."""
    run = RUNS[model]
    cfg = run.config
    module = build_model(model, cfg, "cuda", torch.Generator().manual_seed(0),
                         compute_dtype=DTYPES[cfg.dtype])
    module.load_state_dict(restore_variables(ckpt, "cuda"))
    module.eval()
    loader = BatchLoader(WIDERFaceDataSource(load_targets(root, "val", run.max_faces),
                                             cfg.input_shape, 8, error_log=None),
                         run.batch, drop_last=True)
    maps = []
    with torch.no_grad():
        for batch in DevicePrefetcher(loader, "cuda"):
            maps.append(module(batch.images.float() / 255.0).contiguous())
    return module, maps


def k1_times(module, maps: list[torch.Tensor]) -> dict:
    """K1 on the trained maps against K1 on random maps of the same shape,
    in turns (random, trained, trained, random), each over every map, each
    decoded as the eval step decodes ``module``'s output."""
    prob, iou, cap = NMS
    size = _image_size(module)

    def decode(m):
        return _decode_predictions(module, m, size, prob, iou, cap)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = []
    for m in maps:
        r = torch.rand(m.shape, generator=gen, device="cuda")
        r[..., 3:] *= 0.3
        rand.append(r)

    def over(ms):
        def run():
            for m in ms:
                decode(m)
        return run

    r1, t1, t2, r2 = (device_ms(over(ms), 20) / len(maps)
                      for ms in (rand, maps, maps, rand))
    eligible = [float((m[..., 0] > prob).flatten(1).sum(-1).float().mean()) for m in maps]
    kept = [int(decode(m)[1].sum()) for m in maps]
    eligible_r = [float((m[..., 0] > prob).flatten(1).sum(-1).float().mean()) for m in rand]
    return {
        "shape": [int(maps[0].shape[0]), int(maps[0][0, ..., 0].numel()), cap],
        "trained_ms": (t1 + t2) / 2, "trained_runs_ms": [t1, t2],
        "random_ms": (r1 + r2) / 2, "random_runs_ms": [r1, r2],
        "trained_eligible_per_image_mean": float(np.mean(eligible)),
        "trained_kept_per_batch_mean": float(np.mean(kept)),
        "random_eligible_per_image_mean": float(np.mean(eligible_r)),
        "batches": len(maps),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="poolresnet", choices=sorted(RUNS))
    p.add_argument("--epochs", type=int, default=40, help="epochs (quarter-epochs for ssd)")
    p.add_argument("--bg-push", type=float, default=0.0,
                   help="train_model_ssd's --bg-push (ssd only; 0.0 is the reference loss)")
    p.add_argument("--train-images", type=int, default=2000)
    p.add_argument("--val-images", type=int, default=500)
    p.add_argument("--work", default="build/config_of_record")
    p.add_argument("--out", default="build/config_of_record/summary.json")
    args = p.parse_args(argv)
    if args.bg_push and args.model != "ssd":
        p.error("--bg-push is the SSD loss's")
    if not torch.cuda.is_available():
        raise SystemExit("config_of_record runs on a CUDA card")
    out_path = Path(args.out).absolute()
    work = Path(args.work).absolute()
    work.mkdir(parents=True, exist_ok=True)
    run = RUNS[args.model]
    summary: dict = {"card": card_line(), "device": torch.cuda.get_device_name(0),
                     "model": args.model, "train_images": args.train_images,
                     "val_images": args.val_images, "epochs": args.epochs}
    train_flags = ["--data-dir", "data", "--epochs", str(args.epochs)]
    if args.model == "ssd":
        summary["bg_push"] = args.bg_push
        train_flags += ["--bg-push", str(args.bg_push)]

    t0 = time.perf_counter()
    root = make_synthetic_widerface(work / "data", args.train_images, split="train", seed=0)
    make_synthetic_widerface(root, args.val_images, split="val", seed=1)
    summary["data_s"] = time.perf_counter() - t0

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t_fit = time.time()
        last = run.entry.main(train_flags)
        summary["train_model_s"] = time.time() - t_fit
        name = last.parent.name
        train_s = epoch_train_seconds(work / "logs" / f"out_{name}.jsonl", t_fit)
        # an epoch's images, drop_last
        images = args.train_images // run.epoch_fraction // run.batch * run.batch
        summary["train_epoch_s"] = train_s
        summary["train_img_s_by_epoch"] = [images / s for s in train_s]
        ckpts = sorted((work / "checkpoints" / name).glob("step_*.pt"))
        aps = []
        for ck in ckpts:
            r = run_validation_epoch.main(["--data-dir", "data", "--checkpoint", str(ck),
                                           *run.val_flags, "--with-ap"])
            aps.append(r)
    finally:
        os.chdir(cwd)
    summary["val_by_epoch"] = aps
    ap = [r["AP@0.5"] for r in aps]
    best = int(np.argmax(ap))
    summary["best_epoch"] = best
    summary["best_ap"] = ap[best]
    summary["train_s_to_best"] = float(np.sum(train_s[: best + 1]))
    summary["steady_train_img_s_median"] = float(np.median(summary["train_img_s_by_epoch"][1:]))

    summary["k1_on_val_maps"] = k1_times(*val_maps(ckpts[best], root, args.model))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
