"""PoolResnet's forward over the spatial axis: each rank of a spatial group
computes the output rows it owns of every layer, through
``parallel/halo.py``'s exchanges, and the last layer's rows are gathered into
the whole ``(B, S, S, 5)`` grid on every rank.

It walks PoolResnet's own submodules (``conv1``, ``residual_blocks``,
``head_dropout``, ``out``) with their own parameters, so a ``state_dict``
loads and saves as it does for the model, and the math is
``PoolResnet.forward``'s. One thing moves out of the blocks: a
``ResidualBlock`` pools while *its input's* height exceeds ``pool_until``,
and a shard's height is not the image's. The plan decides each pool from the
global height, and the forward runs each block's convolutions, dropout,
skip and pool itself.

Dropout draws its ``(B, C, 1, 1)`` channel masks from the step's generator;
every rank of a spatial group draws the same ones, as its step seeds the
generator with the data index. With one rank in the group, every exchange
is the identity and every layer the model's own call: the forward is
``PoolResnet.forward``, op for op.

Other families are not ported to the spatial axis (ROADMAP queue 1, items
3-6): :func:`check_spatial` raises for them.
"""

from __future__ import annotations

import dataclasses

import torch

from fdtpu_torch.models.layers import DropoutMasks, ResidualBlock, leaky_relu, max_pool_2x2
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.parallel.halo import (
    Exchange,
    conv_exchange,
    conv_rows,
    gather_rows,
    halo,
    pool_exchange,
)
from fdtpu_torch.parallel.mesh import Mesh

SPATIAL_ROADMAP = ("ROADMAP.md queue 1, items 3-6: the spatial step of the SSD, MobileNetV3, "
                   "Resnet and SeparableCNN")


def check_spatial(module) -> None:
    """Raise ``NotImplementedError`` unless ``module`` is a PoolResnet
    (its own class, not Resnet or SeparableCNN on its body)."""
    if type(module) is not PoolResnet or not all(
            type(b) is ResidualBlock for b in module.residual_blocks):
        raise NotImplementedError(f"the spatial step is ported for PoolResnet only, not "
                                  f"{type(module).__name__}: {SPATIAL_ROADMAP}")


@dataclasses.dataclass(frozen=True)
class PoolResnetPlan:
    """Every exchange of one PoolResnet forward at one image height over
    ``parts`` spatial ranks: the stem's (its ``own_in`` is the image's
    rows), each block's (its convolutions', and its pool's or None), the
    head's (its ``own_out`` is the grid's rows)."""

    stem: Exchange
    blocks: tuple[tuple[Exchange, Exchange | None], ...]
    head: Exchange

    @property
    def image_rows(self) -> tuple[tuple[int, int], ...]:
        return self.stem.own_in


def poolresnet_plan(module: PoolResnet, height: int, parts: int) -> PoolResnetPlan:
    """The exchanges of ``module``'s forward on images ``height`` rows high,
    each block's pool decided on the global height."""
    check_spatial(module)
    stem = conv_exchange(height, module.conv1, parts)
    n, blocks = stem.n_out, []
    for block in module.residual_blocks:
        convs = conv_exchange(n, block.conv1, parts)
        pool = pool_exchange(n, parts) if n > block.pool_until else None
        blocks.append((convs, pool))
        n = pool.n_out if pool else n
    return PoolResnetPlan(stem, tuple(blocks), conv_exchange(n, module.out, parts))


def _rows(ex: Exchange, index: int) -> int:
    a, b = ex.own_out[index]
    return b - a


def spatial_forward(module: PoolResnet, rows: torch.Tensor, plan: PoolResnetPlan, mesh: Mesh,
                    masks: DropoutMasks | None = None) -> torch.Tensor:
    """``module``'s forward from this rank's rows of the images, ``(B, h,
    W, 3)`` (the rows ``plan.image_rows[mesh.spatial_index]``), over the
    mesh's spatial group: the whole ``(B, S, S, 5)`` float32 grid on every
    rank of the group. Dropout applies when given ``masks``."""
    i, group = mesh.spatial_index, mesh.spatial_group

    def layer(conv, x, ex):
        window, top, bottom = halo(x, ex, i, group)
        return conv_rows(conv, window, top, bottom, _rows(ex, i))

    x = rows.permute(0, 3, 1, 2).to(module.compute_dtype or module.conv1.weight.dtype)
    x = layer(module.conv1, x, plan.stem)
    for block, (convs, pool) in zip(module.residual_blocks, plan.blocks):
        skip = x
        x = leaky_relu(layer(block.conv1, x, convs))
        x = layer(block.conv2, x, convs)
        x = block.dropout(leaky_relu(x), masks) + skip
        if pool is not None:
            x = max_pool_2x2(halo(x, pool, i, group)[0])
    x = layer(module.out, module.head_dropout(x, masks), plan.head)
    grid = gather_rows(torch.sigmoid(x.float()), plan.head.own_out, i, group)
    return grid.permute(0, 2, 3, 1).contiguous()
