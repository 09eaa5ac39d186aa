"""Validation-only runner, the port's ``run_validation_epoch.py``: build a
model of any family of the zoo, load a checkpoint (the port's ``.pt`` or a
reference TorchScript ``.pth``), run one evaluation epoch over the val split
and print loss/IoU/recall/precision/F1 (and AP@0.5 with ``--with-ap``, or
the official easy/medium/hard mAP with ``--widerface-gt-dir``).

    python -m fdtpu_torch.run_validation_epoch --data-dir DIR \\
        --checkpoint checkpoints/RUN/step_N.pt          # MobileNetV3, 480 px, grid 15

    python -m fdtpu_torch.run_validation_epoch --data-dir DIR --model poolresnet \\
        --patches 10 --checkpoint checkpoints/RUN/step_N.pt --with-ap

The same flags and defaults as ``run_validation_epoch.py`` (``--model``
defaults to ``mobilenetv3``), with ``--device`` (default ``cuda``) in place
of ``--platform``. ``--model ssd`` validates under the SSD pipeline's
constants, as the original does: ``SSDConfig`` (16 filters by default, the
patch sizes of the input size), the <120-face filter, box capacity 128 and
NMS capacity 128. A ``.pth`` checkpoint goes through
``compat.load_reference_detector``: a grid model is wrapped so that its
reference-layout output decodes to the reference's boxes. On a card the
eval step replays from a CUDA graph (the Trainer's ``runner``), the
official-predictions path too; on the CPU it runs eagerly.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fdtpu_torch.data import BatchLoader, DevicePrefetcher, WIDERFaceDataSource, load_targets
from fdtpu_torch.compat.torch_import import load_reference_detector
from fdtpu_torch.models import DTYPES, FAMILIES, SERVED_ONLY, build_model, ssd_patch_sizes
from fdtpu_torch.train import Trainer
from fdtpu_torch.train.checkpoint import restore_checkpoint
from fdtpu_torch.train.metrics import average_precision, f1_score
from fdtpu_torch.utils.config import DetectorConfig, SSDConfig, TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--model", default="mobilenetv3", choices=list(FAMILIES))
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port (.pt) or a reference TorchScript .pth")
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=15)
    p.add_argument("--filters", type=int, default=None, help="default 128 (16 for ssd)")
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    # reference thresholds: run_validation_epoch.py:20-21
    p.add_argument("--prob-threshold", type=float, default=0.5)
    p.add_argument("--iou-threshold", type=float, default=0.01)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--with-ap", action="store_true", help="also compute AP@0.5")
    p.add_argument("--widerface-gt-dir", default=None,
                   help="official eval_tools ground_truth dir (wider_face_val.mat + "
                        "wider_{easy,medium,hard}_val.mat): run the OFFICIAL "
                        "easy/medium/hard mAP protocol over the val split "
                        "(fdtpu_torch/train/widerface_eval.py). Pair with a low "
                        "--prob-threshold (e.g. 0.02) so the PR sweep isn't truncated "
                        "at the decode gate")
    p.add_argument("--widerface-pred-dir", default=None,
                   help="with --widerface-gt-dir: also dump detections in the official "
                        "submission txt layout")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.model in SERVED_ONLY:
        p.error(f"--model {args.model}: the port serves it and does not evaluate it (no "
                "targets or loss for it yet)")
    return args


def main(argv=None) -> dict:
    """Runs the epoch and returns what it printed, as one dict."""
    args = parse_args(argv)
    shape = (args.input, args.input)
    if args.model == "ssd":
        cfg = SSDConfig(
            filters=args.filters or 16,
            input_shape=shape,
            patch_sizes=ssd_patch_sizes(shape),
            probability_threshold=args.prob_threshold,
            iou_threshold=args.iou_threshold,
        )
        nms_capacity = cfg.nms_capacity
        # the SSD pipeline's <120-face filter and 128-box capacity
        max_faces, box_capacity = 120, 128
    else:
        cfg = DetectorConfig(
            filters=args.filters or 128,
            input_shape=shape,
            num_patches=args.patches,
            num_residual_blocks=args.blocks,
            probability_threshold=args.prob_threshold,
            iou_threshold=args.iou_threshold,
        )
        nms_capacity = 64
        max_faces, box_capacity = 3, 8  # datamodule.py:102
    nms_params = (args.prob_threshold, args.iou_threshold, nms_capacity)
    module = build_model(args.model, cfg, args.device, torch.Generator().manual_seed(0),
                         compute_dtype=DTYPES[cfg.dtype])
    targets = load_targets(args.data_dir, "val", max_faces=max_faces)
    if args.max_images:
        targets = targets[: args.max_images]
    loader = BatchLoader(WIDERFaceDataSource(targets, cfg.input_shape, box_capacity),
                         args.batch_size)
    trainer = Trainer(module, TrainConfig(visualize_first_batch=False), loader, loader,
                      nms_params=nms_params, run_name="validation", device=args.device)
    if args.checkpoint and str(args.checkpoint).endswith(".pth"):
        # a reference TorchScript checkpoint: the eval step serves the
        # (wrapped) imported model
        trainer.module = load_reference_detector(args.checkpoint, module)
        trainer.state.module = trainer.module
        trainer.build_eval_steps()
    elif args.checkpoint:
        trainer.state = restore_checkpoint(args.checkpoint, trainer.state)

    if args.widerface_gt_dir:
        return _official(args, cfg, trainer)
    if not args.with_ap:
        metrics = trainer.test(loader)
        print({k: round(v, 5) for k, v in metrics.items()})
        return metrics

    # one pass: the eval step returns decoded boxes per batch, so scalar
    # metrics and AP inputs accumulate together
    agg: dict[str, list] = {}
    preds, pmasks, gts, gmasks = [], [], [], []
    eval_step = trainer.runner("eval")  # replayed from a CUDA graph on a card
    for batch in DevicePrefetcher(loader, trainer.device):
        scalars, (pb, pm) = eval_step(
            trainer.state, batch.images, batch.boxes, batch.box_mask, batch.sample_mask)
        for k, v in scalars.items():
            agg.setdefault(k, []).append(float(v))
        keep = batch.sample_mask.cpu().numpy()
        preds.append(pb.cpu().numpy()[keep])
        pmasks.append(pm.cpu().numpy()[keep])
        gts.append(batch.boxes.cpu().numpy()[keep])
        gmasks.append(batch.box_mask.cpu().numpy()[keep])
    metrics = {k: float(np.mean(v)) for k, v in agg.items()}
    metrics["f1"] = f1_score(metrics["precision"], metrics["recall"])
    print({k: round(v, 5) for k, v in metrics.items()})
    ap = average_precision(np.concatenate(preds), np.concatenate(pmasks),
                           np.concatenate(gts), np.concatenate(gmasks))
    print({"AP@0.5": round(ap, 5)})
    return {**metrics, "AP@0.5": ap}


def _official(args, cfg, trainer) -> dict:
    """OFFICIAL WIDERFace protocol (easy/medium/hard mAP) over EVERY val
    image (the <3-face filter is a training choice, not an eval one),
    detections rescaled back to the original pixels, where the official
    ground truth lives."""
    from PIL import Image

    from fdtpu_torch.train.widerface_eval import (
        detections_to_official,
        evaluate_widerface,
        write_official_predictions,
    )

    targets = load_targets(args.data_dir, "val", max_faces=10**9)
    if args.max_images:
        targets = targets[: args.max_images]
    loader = BatchLoader(WIDERFaceDataSource(targets, cfg.input_shape, 8), args.batch_size)
    in_size = (cfg.input_shape[1], cfg.input_shape[0])  # (w, h)
    preds = {}
    cursor = 0
    eval_step = trainer.runner("eval")  # replayed from a CUDA graph on a card
    for batch in DevicePrefetcher(loader, trainer.device):
        _, (pb, pm) = eval_step(
            trainer.state, batch.images, batch.boxes, batch.box_mask, batch.sample_mask)
        pb, pm = pb.cpu().numpy(), pm.cpu().numpy()
        for i in range(int(batch.sample_mask.sum())):
            path = targets[cursor]["img_path"]
            with Image.open(path) as im:
                orig = im.size  # header read only
            preds[f"{path.parent.name}/{path.stem}"] = detections_to_official(
                pb[i], pm[i], in_size, orig)
            cursor += 1
    out: dict = {}
    if args.widerface_pred_dir:
        n = write_official_predictions(preds, args.widerface_pred_dir)
        print({"prediction_files": n, "dir": args.widerface_pred_dir})
        out["prediction_files"] = n
    aps = evaluate_widerface(preds, args.widerface_gt_dir)
    print({f"mAP_{k}": round(v, 5) for k, v in aps.items()})
    return {**out, **{f"mAP_{k}": v for k, v in aps.items()}}


if __name__ == "__main__":
    main()
