"""L1 structured channel pruning of the port's PoolResnet and Resnet
(fdtpu's ``compat/pruning.py``, the reference's torch_pruning pass).

Channels are scored by the L1 norm of their conv kernel over (in, kh, kw),
``amount`` of them dropped in each channel space, and the dependent layers
shrink with them. The residual stream ties the stem's output, every
block's input and output and the head's input into one space, scored by
the stem; each block's first conv output is a space of its own. The result
is a new module of the same class at ``filters = kept`` with the kept
channels sliced out of the weights: no masks at run time.

The scores are computed on fdtpu's HWIO layout in float32 numpy, in its
order, and the kept channels are chosen as fdtpu's ``_topk_keep`` chooses
them (a stable sort by descending score, kept in ascending index order), so
the port prunes the same channels as fdtpu from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.resnet import Resnet


def _topk_keep(scores: np.ndarray, keep: int) -> np.ndarray:
    """Indices of the ``keep`` highest-scoring channels, ascending."""
    idx = np.argsort(-scores, kind="stable")[:keep]
    return np.sort(idx)


def l1_scores(layer: nn.Conv2d) -> np.ndarray:
    """Each output channel's L1 norm over (kh, kw, in), summed on the HWIO
    kernel as fdtpu sums it."""
    hwio = np.ascontiguousarray(layer.weight.detach().cpu().float().numpy().transpose(2, 3, 1, 0))
    return np.abs(hwio).sum(axis=(0, 1, 2))


def kept_filters(filters: int, amount: float, align: int | None = None) -> int:
    """torch_pruning's count of the channels left, ``filters - round(filters
    * amount)``; ``align`` rounds it down to a multiple (not below
    ``align``)."""
    keep = filters - int(round(filters * amount))
    if align:
        keep = max(align, (keep // align) * align)
    if keep < 1:
        raise ValueError(f"nothing left of {filters} channels at amount {amount}")
    return keep


def _empty_like(model: PoolResnet, filters: int) -> PoolResnet:
    """A module of ``model``'s class and geometry at ``filters`` channels."""
    blocks = model.residual_blocks
    common = dict(
        num_residual_blocks=model.num_residual_blocks,
        output_kernel_size=model.output_kernel_size,
        dropout=blocks[0].dropout.rate if len(blocks) else 0.25,
        head_dropout=model.head_dropout.rate,
        compute_dtype=model.compute_dtype,
        fused_tail=bool(len(blocks) and blocks[0].fused_tail),
        generator=torch.Generator().manual_seed(0),  # overwritten by the sliced weights
    )
    if type(model) is Resnet:
        return Resnet(filters, model.input_shape, model.num_patches, **common)
    if type(model) is PoolResnet:
        return PoolResnet(filters, model.input_shape, model.num_patches,
                          input_kernel_size=model.input_kernel_size,
                          input_stride=model.input_stride,
                          output_padding=model.output_padding, **common)
    raise ValueError(f"pruning takes PoolResnet or Resnet, not {type(model).__name__}")


def prune_l1_structured(model: PoolResnet, amount: float = 0.2,
                        align: int | None = None) -> PoolResnet:
    """``model`` with ``amount`` of the channels of every conv removed by L1
    score; returns a new module at the reduced width, on ``model``'s device
    and dtype.

    ``align`` rounds the kept count down to a multiple (64, 128): fdtpu
    measured 128 -> 102 channels slower than 128 on its TPU, whose matrix
    unit wastes tiles at widths off 128. Without it the count is
    torch_pruning's for ``amount``."""
    if type(model) not in (PoolResnet, Resnet):
        raise ValueError(f"pruning takes PoolResnet or Resnet, not {type(model).__name__}")
    keep = kept_filters(model.conv1.out_channels, amount, align)
    stream = torch.from_numpy(_topk_keep(l1_scores(model.conv1), keep))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    new = {"conv1.weight": sd["conv1.weight"][stream]}
    if "conv1.bias" in sd:
        new["conv1.bias"] = sd["conv1.bias"][stream]
    for i, block in enumerate(model.residual_blocks):
        p = f"residual_blocks.{i}"
        internal = torch.from_numpy(_topk_keep(l1_scores(block.conv1), keep))
        new[f"{p}.conv1.weight"] = sd[f"{p}.conv1.weight"][internal][:, stream]
        new[f"{p}.conv2.weight"] = sd[f"{p}.conv2.weight"][stream][:, internal]
        if f"{p}.conv1.bias" in sd:
            new[f"{p}.conv1.bias"] = sd[f"{p}.conv1.bias"][internal]
        if f"{p}.conv2.bias" in sd:
            new[f"{p}.conv2.bias"] = sd[f"{p}.conv2.bias"][stream]
    new["out.weight"] = sd["out.weight"][:, stream]
    if "out.bias" in sd:
        new["out.bias"] = sd["out.bias"]
    weight = model.conv1.weight
    pruned = _empty_like(model, keep)
    pruned.load_state_dict({k: v.contiguous() for k, v in new.items()})
    return pruned.to(device=weight.device, dtype=weight.dtype)
