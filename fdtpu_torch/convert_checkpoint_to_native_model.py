"""Checkpoint -> native ``.fdn`` artifact, the port's
``demo_scripts/convert_checkpoint_to_native_model.py`` (the reference's
lite-interpreter converter): a flat op program and float32 weights that the
C++ engine (``fdtpu_torch.native``) runs with no ML framework, for every
family of the zoo (BatchNorm folded, the SSD's heads and prior decode).
``--quantize int8`` stores the dense convs' weights as int8, about 4x
smaller, with activations quantized at serving time. Its detections are not
held to the float32 artifact's, and can differ widely (most of all the
SSD's), so the converter warns: compare both artifacts on your own frames
(``fdtpu_torch.demo_model_native``) before shipping the int8 one.

    python -m fdtpu_torch.convert_checkpoint_to_native_model --checkpoint PATH [--quantize int8]
"""

from __future__ import annotations

import argparse
import warnings

from fdtpu_torch.convert_checkpoint_to_exported_model import add_model_args, load_model
from fdtpu_torch.export import export_native


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p, "saved_models/native/model.fdn")
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8: per-channel 7-bit weights, activations quantized at serving")
    args = p.parse_args(argv)
    if args.quantize == "int8":
        warnings.warn("int8 weights change the detections, and are not held to the float32 "
                      "artifact's: compare both on your own frames before shipping this one",
                      stacklevel=2)
    path = export_native(load_model(args), args.out,
                         probability_threshold=args.prob_threshold,
                         iou_threshold=args.iou_threshold, capacity=args.capacity,
                         weight_quant=None if args.quantize == "none" else args.quantize)
    print(f"exported {path} ({path.stat().st_size / 1e6:.2f} MB)")
    return path


if __name__ == "__main__":
    main()
