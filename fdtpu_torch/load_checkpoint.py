"""Checkpoint smoke loader, the port's ``load_checkpoint.py``: load a
checkpoint of the port, fetch one validation sample, decode ground-truth
and predicted boxes, print both. ``--model ssd`` builds the SSD, its patch
sizes from ``--input``.

    python -m fdtpu_torch.load_checkpoint --data-dir DIR --checkpoint PATH [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from fdtpu_torch.core.nms import compact_boxes
from fdtpu_torch.data import WIDERFaceDataSource, load_targets
from fdtpu_torch.models import DTYPES, Detector, build_model
from fdtpu_torch.train.checkpoint import restore_variables
from fdtpu_torch.utils.config import DetectorConfig


def main(argv=None):
    """Prints and returns ``(ground-truth boxes, predicted boxes)`` as
    ragged numpy arrays."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default="poolresnet")
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=10)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = DetectorConfig(
        filters=args.filters, input_shape=(args.input, args.input),
        num_patches=args.patches, num_residual_blocks=args.blocks,
    )
    module = build_model(args.model, cfg, args.device, torch.Generator().manual_seed(0))
    if args.checkpoint:
        # before the Detector is built: it serves a copy of the params
        module.load_state_dict(restore_variables(args.checkpoint, args.device))
    det = Detector(module, nms_capacity=cfg.nms_capacity, dtype=DTYPES[cfg.dtype])

    targets = load_targets(args.data_dir, "val", max_faces=3)
    src = WIDERFaceDataSource(targets, cfg.input_shape, 8)
    img, gt_boxes, gt_mask = src.get(0)
    print("ground truth boxes:")
    print(gt_boxes[gt_mask])

    _, boxes, mask = det.predict(img)
    pred = compact_boxes(boxes, mask)
    print("predicted boxes:")
    print(pred)
    return gt_boxes[gt_mask], pred


if __name__ == "__main__":
    main()
