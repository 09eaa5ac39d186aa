"""Checkpoint -> exported predict program, the port's
``demo_scripts/convert_checkpoint_to_exported_model.py`` (the reference's
``convert_checkpoint_to_scripted_model.py``): ``torch.export`` of the
predict program (``/255``, the bf16 forward, decode+filter+NMS through K1)
with the weights inside, saved as a ``.pt2`` for ``demo_model_exported``
and ``fdtpu_torch.export.load_exported``. Thresholds default to the
reference's (0.7, 0.01). Export on the device the artifact will serve on.

    python -m fdtpu_torch.convert_checkpoint_to_exported_model --checkpoint PATH [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from fdtpu_torch.export import export_predict
from fdtpu_torch.models import DTYPES, FAMILIES, build_model
from fdtpu_torch.utils.config import DetectorConfig, serving_config


def add_model_args(p: argparse.ArgumentParser, out: str) -> None:
    """The flags the converters share (the root scripts')."""
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port (.pt) or a reference TorchScript .pth")
    p.add_argument("--out", default=out)
    p.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=10)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--prob-threshold", type=float, default=0.7)
    p.add_argument("--iou-threshold", type=float, default=0.01)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")


def load_model(args) -> torch.nn.Module:
    """The model the flags name, on ``--device``, with ``--checkpoint``'s
    weights (random from seed 0 without one); a reference grid checkpoint
    comes wrapped in ``ReferenceLayoutGrid``. The SSD's patch sizes follow
    from ``--input``; RetinaFace's config is its own (``serving_config``),
    and both exports refuse it."""
    from fdtpu_torch.demo_model import load_weights

    cfg = serving_config(args.model, args.input, filters=args.filters,
                         num_patches=args.patches, num_residual_blocks=args.blocks)
    module = build_model(args.model, cfg, args.device, torch.Generator().manual_seed(0))
    return load_weights(module, args.checkpoint, args.device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p, "saved_models/exported/model.pt2")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--dtype", default=DetectorConfig().dtype, choices=list(DTYPES))
    args = p.parse_args(argv)
    path = export_predict(load_model(args), args.out, batch_size=args.batch,
                          probability_threshold=args.prob_threshold,
                          iou_threshold=args.iou_threshold, capacity=args.capacity,
                          dtype=DTYPES[args.dtype])
    print(f"exported {path} ({path.stat().st_size / 1e6:.2f} MB)")
    return path


if __name__ == "__main__":
    main()
