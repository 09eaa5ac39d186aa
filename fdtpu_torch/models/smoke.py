"""The ``__main__`` smoke block of each model file (``fdtpu/models/smoke.py``):
build the model from seed 0, print :meth:`Detector.summary`, time the
bfloat16 serving forward and print the output shape. Runs on the card
unless ``--device cpu`` is given::

    python -m fdtpu_torch.models.mobilenetv3 [--device cpu] [--batch 1] [--iters 10]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch


def smoke(module: torch.nn.Module, batch: int = 1, iters: int = 10) -> dict:
    """Summary and forward timing of ``module`` (on its device) at ``batch``;
    returns the output shape and the ms a forward."""
    from fdtpu_torch.models.detector import Detector

    det = Detector(module)
    print(det.summary())
    h, w = module.input_shape
    x = torch.zeros((batch, h, w, 3), device=det.device)

    def sync():
        if det.device.type == "cuda":
            torch.cuda.synchronize()

    out = det.apply(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = det.apply(x)
    sync()
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"input {(batch, h, w, 3)} -> output {tuple(out.shape)}; bf16 forward {ms:.2f} ms "
          f"({batch * 1e3 / ms:.1f} FPS, {det.device.type})")
    return {"shape": tuple(out.shape), "ms": ms}


def smoke_main(build: Callable[[torch.Generator], torch.nn.Module], argv=None) -> dict:
    """A model file's ``__main__``: ``build(generator)`` is the model."""
    p = argparse.ArgumentParser(description="model smoke benchmark")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    module = build(torch.Generator().manual_seed(0)).to(args.device)
    return smoke(module, args.batch, args.iters)
