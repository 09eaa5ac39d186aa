"""Native-engine demo, the port's ``demo_scripts/demo_model_native.py``: run
a ``.fdn`` artifact through the port's C++ engine (no ML framework in the
call; numpy and PIL for the image files only) and draw the boxes. Convert
a checkpoint first with ``python -m
fdtpu_torch.convert_checkpoint_to_native_model``.

    python -m fdtpu_torch.demo_model_native --artifact saved_models/native/model.fdn
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from fdtpu_torch.demo_model_exported import image_paths, resized
from fdtpu_torch.native import NativeDetector
from fdtpu_torch.utils.draw import draw_bbx


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default="saved_models/native/model.fdn")
    p.add_argument("--images", default="imgs/test_imgs")
    p.add_argument("--out", default="imgs/annotated_imgs")
    args = p.parse_args(argv)

    det = NativeDetector(args.artifact)  # loading validates the artifact
    h, w = det.input_shape
    print(f"loaded {args.artifact} (input {h}x{w}, capacity {det.capacity})")
    counts = []
    for path in image_paths(args.images):
        img = resized(path, h, w)
        t0 = time.perf_counter()
        boxes, mask = det.predict(img)
        dt = (time.perf_counter() - t0) * 1000
        n = int(mask[0].sum())
        print(f"{path.name}: {n} boxes, {dt:.1f} ms")
        draw_bbx(img.astype(np.float32) / 255.0, boxes[0][mask[0]], save_name=path.stem,
                 out_dir=args.out)
        counts.append(n)
    return counts


if __name__ == "__main__":
    main()
