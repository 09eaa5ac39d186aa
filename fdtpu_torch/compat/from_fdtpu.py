"""Carry fdtpu's Flax params across to the port's modules.

fdtpu keeps conv kernels in HWIO; torch keeps them in OIHW. The names follow
the reference torch model, the same mapping ``fdtpu/compat/torch_import.py``
applies in the other direction.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(tree, prefix: str) -> dict[str, torch.Tensor]:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        f"{prefix}.bias": torch.from_numpy(np.array(tree["bias"], dtype=np.float32)),
    }


def poolresnet_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``PoolResnet`` params (the ``variables["params"]`` tree, numpy
    leaves) -> the port's ``PoolResnet`` ``state_dict``.

    ``Conv_0`` -> ``conv1``; ``ResidualBlock_{i}/Conv_{0,1}`` ->
    ``residual_blocks.{i}.conv{1,2}``; ``Conv_1`` (the head) -> ``out``.
    Params of a ``fast_stem=True`` model have the same tree and load too.
    """
    blocks = sorted(
        (k for k in params if k.startswith("ResidualBlock_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    unknown = set(params) - {"Conv_0", "Conv_1", *blocks}
    if unknown:
        raise ValueError(f"not a PoolResnet param tree: unexpected {sorted(unknown)}")
    sd = _conv(params["Conv_0"], "conv1")
    for i, name in enumerate(blocks):
        if name != f"ResidualBlock_{i}":
            raise ValueError(f"residual blocks are not numbered 0..{len(blocks) - 1}")
        sd.update(_conv(params[name]["Conv_0"], f"residual_blocks.{i}.conv1"))
        sd.update(_conv(params[name]["Conv_1"], f"residual_blocks.{i}.conv2"))
    sd.update(_conv(params["Conv_1"], "out"))
    return sd
