"""Structured pruning, the port's ``pruner.py``: L1-prune a PoolResnet
(``compat/pruning.py``) and time ten eval forwards before and after, as the
reference's ``pruner.py`` does with torch_pruning (amount 0.2). The weights
come from ``--checkpoint`` (a checkpoint of the port), else random from
seed 0; ``--save`` writes the pruned model as a
checkpoint that ``demo_model --filters <kept>`` and the converters read.

    python -m fdtpu_torch.pruner [--amount 0.2] [--align 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from fdtpu_torch.compat.pruning import prune_l1_structured
from fdtpu_torch.models import Detector, build_model
from fdtpu_torch.train.checkpoint import restore_variables
from fdtpu_torch.utils.config import DetectorConfig


def benchmark_model(module, batch: int, size: int, iters: int = 10) -> tuple[float, float]:
    """Seconds a batch and images a second of ``iters`` eval forwards of the
    served (bfloat16) copy, after one warm-up; the reference's 10-forward
    wall clock."""
    det = Detector(module)
    x = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    ).to(det.device)

    def sync():
        if det.device.type == "cuda":
            torch.cuda.synchronize(det.device)

    det.apply(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        det.apply(x)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return dt, batch / dt


def n_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=None, help="a checkpoint of the port (.pt)")
    p.add_argument("--input", type=int, default=480)
    p.add_argument("--patches", type=int, default=10)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--amount", type=float, default=0.2, help="fraction of channels to prune")
    p.add_argument("--align", type=int, default=None,
                   help="round the kept channels down to this multiple")
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--save", default=None, help="write the pruned model's checkpoint here")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = DetectorConfig(filters=args.filters, input_shape=(args.input, args.input),
                         num_patches=args.patches, num_residual_blocks=args.blocks)
    module = build_model("poolresnet", cfg, args.device, torch.Generator().manual_seed(0))
    if args.checkpoint:
        module.load_state_dict(restore_variables(args.checkpoint, args.device))
    dt, fps = benchmark_model(module, args.batch, args.input)
    print(f"before: {n_params(module) / 1e6:.3f}M params, {dt * 1000:.1f} ms/batch, "
          f"{fps:.1f} img/s")
    pruned = prune_l1_structured(module, args.amount, align=args.align)
    dt, fps = benchmark_model(pruned, args.batch, args.input)
    print(f"after:  {n_params(pruned) / 1e6:.3f}M params ({pruned.conv1.out_channels} "
          f"channels), {dt * 1000:.1f} ms/batch, {fps:.1f} img/s")
    if args.save:
        path = Path(args.save)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save({"step": 0, "module": pruned.state_dict()}, tmp)
        os.replace(tmp, path)
        print(f"saved the pruned model to {path} (--filters {pruned.conv1.out_channels})")
    return module, pruned


if __name__ == "__main__":
    main()
