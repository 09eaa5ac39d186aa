"""Inference demo, the port's ``demo_model.py``: over image files, or a
webcam with ``--camera``.

Each image goes through :meth:`Detector.predict` (host resize, ``/255``,
forward, fused decode+filter+NMS); the boxes are drawn on the resized frame
and saved. An image directory without images gets three synthetic frames
(``make_synthetic_widerface``), as fdtpu's demo does. ``--camera`` runs the
reference's webcam loop instead (OpenCV, camera 0, ESC stops it), the
frames through the same ``predict``. ``--model`` names the family (any of
the zoo; the SSD's patch sizes follow from ``--input``; ``retinaface``
takes ``cfg_re50``'s widths at ``--input``, ``detect.py``'s thresholds 0.6
and 0.4 and capacity 750 unless given, and the image demo prints each
face's five points). The weights come
from ``--checkpoint``: a checkpoint of the port (as ``train_model`` or
``train_model_ssd`` writes it, or ``convert_fdtpu_checkpoint.py`` from
fdtpu's), or a reference TorchScript ``.pth``, imported through
``compat.load_reference_detector``; without one they are random, drawn
from seed 0. Run as::

    python -m fdtpu_torch.demo_model --images DIR --checkpoint PATH --device cuda
    python -m fdtpu_torch.demo_model --camera --checkpoint PATH
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
from fdtpu_torch.utils.config import RetinaFaceConfig, serving_config
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
    p.add_argument("--prob-threshold", type=float, default=None,
                   help="default 0.7, the reference demo's; retinaface: 0.6, detect.py's")
    p.add_argument("--iou-threshold", type=float, default=None,
                   help="default 0.01, the reference demo's; retinaface: 0.4, detect.py's")
    p.add_argument("--camera", action="store_true", help="webcam loop (needs cv2)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def build_detector(args) -> Detector:
    cfg = serving_config(args.model, args.input, filters=args.filters,
                         num_patches=args.patches, num_residual_blocks=args.blocks)
    prob, iou = thresholds(args, cfg)
    gen = torch.Generator().manual_seed(0)
    module = build_model(args.model, cfg, device=args.device, generator=gen)
    # before the Detector is built: it serves a copy of the params
    module = load_weights(module, args.checkpoint, args.device)
    return Detector(
        module,
        probability_threshold=prob,
        iou_threshold=iou,
        nms_capacity=cfg.nms_capacity,
        dtype=DTYPES[cfg.dtype],
    )


def thresholds(args, cfg) -> tuple[float, float]:
    """``--prob-threshold`` and ``--iou-threshold``; by default the
    reference demo's 0.7 and 0.01 for the zoo, and ``detect.py``'s (the
    config's) for RetinaFace."""
    prob, iou = ((cfg.probability_threshold, cfg.iou_threshold)
                 if isinstance(cfg, RetinaFaceConfig) else (0.7, 0.01))
    return (prob if args.prob_threshold is None else args.prob_threshold,
            iou if args.iou_threshold is None else args.iou_threshold)


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
        print(f"no images in {image_dir}; generating a synthetic frame")
        import tempfile

        from fdtpu_torch.data import make_synthetic_widerface

        root = make_synthetic_widerface(tempfile.mkdtemp(), num_images=3)
        paths = sorted((Path(root) / "WIDER_train/images/0--Synthetic").glob("*.jpg"))
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        t0 = time.perf_counter()
        pred = det.predict(img)
        norm, boxes, mask = pred
        n = int(mask.sum())  # waits for the device
        dt = time.perf_counter() - t0
        print(f"{p.name}: {n} faces in {dt*1000:.1f} ms")
        if pred.landmarks is not None:
            for row, pts in zip(compact_boxes(boxes, mask), pred.landmarks[:n].cpu().numpy()):
                print(f"  box {np.round(row[1:], 1).tolist()} points "
                      f"{np.round(pts, 1).tolist()}")
        draw_bbx(norm.cpu().numpy(), compact_boxes(boxes, mask), save_name=p.stem, out_dir=out_dir)


def run_camera(det: Detector) -> None:
    """The reference's webcam loop (``demo_model.py:40-57``), as fdtpu's:
    each BGR frame of camera 0 goes to RGB and through
    :meth:`Detector.predict`; the kept boxes are drawn in blue, width 2, on
    the model-resized frame (predict's coordinates are in that frame) and
    the frame is shown. ESC (27) or a failed read stops the loop."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("--camera needs OpenCV (the cv2 module), which is not installed") from e

    vid = cv2.VideoCapture(0)
    while True:
        ret, frame = vid.read()
        if not ret:
            break
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        norm, boxes, mask = det.predict(rgb)
        display = cv2.cvtColor((norm.cpu().numpy() * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        for b in compact_boxes(boxes, mask):
            x, y, w, h = (int(v) for v in b[1:])
            cv2.rectangle(display, (x, y), (x + w, y + h), (255, 0, 0), 2)
        cv2.imshow("fdtpu_torch", display)
        if cv2.waitKey(1) == 27:  # ESC (demo_model.py:53)
            break
    vid.release()
    cv2.destroyAllWindows()


def main(argv=None) -> None:
    args = parse_args(argv)
    det = build_detector(args)
    if args.camera:
        run_camera(det)
    else:
        run_images(det, args.images, args.out)


if __name__ == "__main__":
    main()
