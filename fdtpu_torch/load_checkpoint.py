"""Checkpoint smoke loader, the port's ``load_checkpoint.py``: load a
checkpoint (the port's ``.pt`` or a reference TorchScript ``.pth``), fetch
one validation sample, decode ground-truth and predicted boxes, print both.
``--model`` names any family of the zoo; ``ssd`` takes its patch sizes
from ``--input``; ``retinaface`` serves at ``--input`` with ``cfg_re50``'s
widths and ``detect.py``'s thresholds (0.6, 0.4, 750 rows), and prints
each predicted face's five points too.

    python -m fdtpu_torch.load_checkpoint --data-dir DIR --checkpoint PATH [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from fdtpu_torch.core.nms import compact_boxes
from fdtpu_torch.data import WIDERFaceDataSource, load_targets
from fdtpu_torch.demo_model import load_weights
from fdtpu_torch.models import DTYPES, FAMILIES, Detector, build_model
from fdtpu_torch.utils.config import serving_config


def main(argv=None):
    """Prints and returns ``(ground-truth boxes, predicted boxes)`` as
    ragged numpy arrays."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=10)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = serving_config(args.model, args.input, filters=args.filters,
                         num_patches=args.patches, num_residual_blocks=args.blocks)
    module = build_model(args.model, cfg, args.device, torch.Generator().manual_seed(0))
    # before the Detector is built: it serves a copy of the params
    module = load_weights(module, args.checkpoint, args.device)
    det = Detector(module, cfg.probability_threshold, cfg.iou_threshold, cfg.nms_capacity,
                   DTYPES[cfg.dtype])

    targets = load_targets(args.data_dir, "val", max_faces=3)
    src = WIDERFaceDataSource(targets, cfg.input_shape, 8)
    img, gt_boxes, gt_mask = src.get(0)
    print("ground truth boxes:")
    print(gt_boxes[gt_mask])

    answer = det.predict(img)
    _, boxes, mask = answer
    pred = compact_boxes(boxes, mask)
    print("predicted boxes:")
    print(pred)
    if answer.landmarks is not None:
        print("their five points:")
        print(answer.landmarks[: len(pred)].cpu().numpy())
    return gt_boxes[gt_mask], pred


if __name__ == "__main__":
    main()
