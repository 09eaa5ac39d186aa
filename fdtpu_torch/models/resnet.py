"""Resnet grid detector (``fdtpu/models/resnet.py``).

Stem conv 3x3 stride 2 (pad 1) -> residual blocks that max-pool while the
spatial size exceeds the grid (PoolResnet's pool while it exceeds twice the
grid) -> Dropout2d(0.5) -> a 3x3 head conv (pad 1) -> float32 sigmoid.
Output ``(B, S, S, 5)``. The body is PoolResnet's with that geometry, so
the ``fused_tail`` option (K6) comes with its blocks; it is off by default,
as fdtpu wires its epilogue into no model.
"""

from __future__ import annotations

import torch

from fdtpu_torch.models.poolresnet import PoolResnet


class Resnet(PoolResnet):
    """Args mirror fdtpu's ``Resnet``; the submodule names are PoolResnet's
    (the reference's): ``conv1``, ``residual_blocks.{i}.conv1/.conv2``,
    ``out``."""

    POOL_FACTOR = 1

    def __init__(
        self,
        filters: int,
        input_shape: tuple[int, int],  # (height, width)
        num_patches: int,
        num_residual_blocks: int = 10,
        output_kernel_size: int = 3,
        dropout: float = 0.25,
        head_dropout: float = 0.5,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
        fused_tail: bool = False,
    ):
        super().__init__(
            filters, input_shape, num_patches, num_residual_blocks,
            input_kernel_size=3, input_stride=2, output_kernel_size=output_kernel_size,
            output_padding=1, dropout=dropout, head_dropout=head_dropout, generator=generator,
            compute_dtype=compute_dtype, fused_tail=fused_tail,
        )


if __name__ == "__main__":  # smoke benchmark
    from fdtpu_torch.models.smoke import smoke_main

    smoke_main(lambda gen: Resnet(64, (320, 320), 15, 10, generator=gen))
