"""Exported-program demo, the port's ``demo_scripts/demo_model_exported.py``
(the reference's ``demo_model_onnx.py``): load a ``.pt2`` predict program
(loading validates it), then run each image through it, resized to the
model's input on the host, and draw the boxes. The frames go to the device
the program was exported on (``--device``).

    python -m fdtpu_torch.demo_model_exported --artifact saved_models/exported/model.pt2
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from fdtpu_torch.core.nms import compact_boxes
from fdtpu_torch.export import load_exported
from fdtpu_torch.utils.draw import draw_bbx

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def image_paths(image_dir: str) -> list[Path]:
    paths = sorted(p for p in Path(image_dir).glob("*") if p.suffix.lower() in IMAGE_SUFFIXES)
    if not paths:
        raise SystemExit(f"no .jpg/.jpeg/.png images in {image_dir}")
    return paths


def resized(path: Path, h: int, w: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB").resize((w, h), Image.BILINEAR))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="saved_models/exported/model.pt2")
    p.add_argument("--images", default="imgs/test_imgs")
    p.add_argument("--out", default="imgs/annotated_imgs")
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--device", default="cuda", help="the device the artifact was exported on")
    args = p.parse_args(argv)

    predict = load_exported(args.artifact)
    print(f"loaded {args.artifact}")
    counts = []
    for path in image_paths(args.images):
        img = resized(path, args.input, args.input)
        x = torch.from_numpy(img.astype(np.float32)[None]).to(args.device)
        t0 = time.perf_counter()
        boxes, mask = predict(x)
        n = int(mask[0].sum())  # waits for the device
        dt = (time.perf_counter() - t0) * 1000
        print(f"{path.name}: {n} boxes, {dt:.1f} ms")
        draw_bbx(img.astype(np.float32) / 255.0, compact_boxes(boxes[0], mask[0]),
                 save_name=path.stem, out_dir=args.out)
        counts.append(n)
    return counts


if __name__ == "__main__":
    main()
