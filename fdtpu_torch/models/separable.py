"""SeparableCNN grid detector (``fdtpu/models/separable.py``).

PoolResnet's stem (k10 stride 8, pad 2) and head (k6, pad 0), with
depthwise-separable residual blocks (pointwise -> depthwise -> pointwise,
all bias-free) that max-pool while the spatial size exceeds the grid. The
grid defaults to 16 patches, as the reference hardcodes it. fdtpu's
``fast_stem`` (``TwoStageStemConv``) is a TPU lowering of the same stem
with the same params: it is left out, and its params load here unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from fdtpu_torch.models.layers import SeparableResidualBlock
from fdtpu_torch.models.poolresnet import PoolResnet


class SeparableCNN(PoolResnet):
    """Args mirror fdtpu's ``SeparableCNN``; submodules ``conv1``,
    ``residual_blocks.{i}.pointwise_conv1/.depthwise_conv/.pointwise_conv2``
    and ``out``, the reference torch model's names."""

    POOL_FACTOR = 1

    def __init__(
        self,
        filters: int,
        input_shape: tuple[int, int],  # (height, width)
        num_patches: int = 16,
        num_residual_blocks: int = 10,
        input_kernel_size: int = 10,
        input_stride: int = 8,
        output_kernel_size: int = 6,
        output_padding: int = 0,
        dropout: float = 0.25,
        head_dropout: float = 0.5,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__(
            filters, input_shape, num_patches, num_residual_blocks, input_kernel_size,
            input_stride, output_kernel_size, output_padding, dropout, head_dropout,
            generator=generator, compute_dtype=compute_dtype,
        )

    @staticmethod
    def _block(filters: int, pool_until: int, dropout: float, fused_tail: bool) -> nn.Module:
        return SeparableResidualBlock(filters, pool_until=pool_until, dropout=dropout)


if __name__ == "__main__":  # smoke benchmark
    from fdtpu_torch.models.smoke import smoke_main

    smoke_main(lambda gen: SeparableCNN(64, (320, 320), 15, 10, generator=gen))
