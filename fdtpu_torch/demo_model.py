"""Inference demo over image files, the port's ``demo_model.py``.

Each image goes through :meth:`Detector.predict` (host resize, ``/255``,
forward, fused decode+filter+NMS); the boxes are drawn on the resized frame
and saved. ``--model`` names the family (any of the zoo; the SSD's patch
sizes follow from ``--input``). The weights come from ``--checkpoint``: a
checkpoint of the port (as ``train_model`` or ``train_model_ssd`` writes
it), or a reference TorchScript ``.pth``, imported through
``compat.load_reference_detector``; without one they are random, drawn
from seed 0. Run as::

    python -m fdtpu_torch.demo_model --images DIR --checkpoint PATH --device cuda
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from fdtpu_torch.core.nms import compact_boxes
from fdtpu_torch.compat.torch_import import load_reference_detector
from fdtpu_torch.models import DTYPES, FAMILIES, Detector, build_model
from fdtpu_torch.train.checkpoint import restore_variables
from fdtpu_torch.utils.config import DetectorConfig
from fdtpu_torch.utils.draw import draw_bbx


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", default="imgs/test_imgs", help="input image dir")
    p.add_argument("--out", default="imgs/annotated_imgs")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port (.pt) or a reference TorchScript .pth")
    p.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=10)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--prob-threshold", type=float, default=0.7)
    p.add_argument("--iou-threshold", type=float, default=0.01)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def build_detector(args) -> Detector:
    cfg = DetectorConfig(
        filters=args.filters,
        input_shape=(args.input, args.input),
        num_patches=args.patches,
        num_residual_blocks=args.blocks,
    )
    gen = torch.Generator().manual_seed(0)
    module = build_model(args.model, cfg, device=args.device, generator=gen)
    # before the Detector is built: it serves a copy of the params
    module = load_weights(module, args.checkpoint, args.device)
    return Detector(
        module,
        probability_threshold=args.prob_threshold,
        iou_threshold=args.iou_threshold,
        nms_capacity=cfg.nms_capacity,
        dtype=DTYPES[cfg.dtype],
    )


def load_weights(module, checkpoint: str | None, device):
    """``module`` with ``checkpoint``'s weights: a reference ``.pth``
    through ``load_reference_detector`` (a grid model comes back wrapped),
    a checkpoint of the port into ``module`` itself; ``module`` as it is
    without one."""
    if checkpoint and str(checkpoint).endswith(".pth"):
        return load_reference_detector(checkpoint, module)
    if checkpoint:
        module.load_state_dict(restore_variables(checkpoint, device))
    return module


def run_images(det: Detector, image_dir: str, out_dir: str) -> None:
    from PIL import Image

    paths = sorted(
        p for p in Path(image_dir).glob("*")
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if not paths:
        raise SystemExit(f"no .jpg/.jpeg/.png images in {image_dir}")
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        t0 = time.perf_counter()
        norm, boxes, mask = det.predict(img)
        n = int(mask.sum())  # waits for the device
        dt = time.perf_counter() - t0
        print(f"{p.name}: {n} faces in {dt*1000:.1f} ms")
        draw_bbx(norm.cpu().numpy(), compact_boxes(boxes, mask), save_name=p.stem, out_dir=out_dir)


def main(argv=None) -> None:
    args = parse_args(argv)
    run_images(build_detector(args), args.images, args.out)


if __name__ == "__main__":
    main()
