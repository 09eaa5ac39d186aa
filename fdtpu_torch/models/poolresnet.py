"""PoolResnet grid detector (``fdtpu/models/poolresnet.py``).

Stem conv k=10 stride=8 (480 -> 60), residual blocks that max-pool while
the spatial size exceeds twice the grid, then a valid head conv (k=6 by
default, 15 -> 10 at 480 px / grid 10) and a float32 sigmoid.

The stem is the plain convolution; fdtpu's two-stage stem lowering has the
same math and the same params, so its weights load here unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from fdtpu_torch.models.layers import Dropout2d, DropoutMasks, ResidualBlock, conv, lecun_normal_


class PoolResnet(nn.Module):
    """Args mirror fdtpu's ``PoolResnet``. Submodules are named after the
    reference torch model: ``conv1``, ``residual_blocks.{i}.conv1/.conv2``,
    ``out``.

    ``forward`` takes ``(B, H, W, 3)`` images and returns the ``(B, S, S, 5)``
    float32 grid map. It computes in ``compute_dtype``, or in the dtype of
    the module's weights when that is None: a bfloat16 copy of the module
    runs in bfloat16, and so does a float32 module with ``compute_dtype =
    torch.bfloat16`` (float32 params, as Flax's ``dtype=bfloat16``; what a
    train step needs). The head's output is cast to float32 before its
    sigmoid. Dropout applies only when ``forward`` is given
    :class:`~fdtpu_torch.models.layers.DropoutMasks` (fdtpu's ``train=True``).
    ``fused_tail`` (eval only) gives every residual block the fused tail
    kernel (:class:`~fdtpu_torch.models.layers.ResidualBlock`).

    Resnet and SeparableCNN share this body (``models/resnet.py``,
    ``models/separable.py``): they set ``POOL_FACTOR`` and ``_block``.
    """

    POOL_FACTOR = 2  # the blocks pool while the height exceeds POOL_FACTOR * num_patches

    def __init__(
        self,
        filters: int,
        input_shape: tuple[int, int],  # (height, width)
        num_patches: int,
        num_residual_blocks: int = 10,
        input_kernel_size: int = 10,
        input_stride: int = 8,
        output_kernel_size: int = 6,
        output_padding: int = 0,
        dropout: float = 0.25,
        head_dropout: float = 0.5,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
        fused_tail: bool = False,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_shape = tuple(input_shape)
        self.num_patches = num_patches
        self.num_residual_blocks = num_residual_blocks
        self.input_kernel_size = input_kernel_size
        self.input_stride = input_stride
        self.output_kernel_size = output_kernel_size
        self.output_padding = output_padding

        pad = input_kernel_size - input_stride
        self.conv1 = nn.Conv2d(3, filters, input_kernel_size, stride=input_stride, padding=pad)
        self.residual_blocks = nn.ModuleList(
            self._block(filters, self.POOL_FACTOR * num_patches, dropout, fused_tail)
            for _ in range(num_residual_blocks)
        )
        self.head_dropout = Dropout2d(head_dropout)
        self.out = nn.Conv2d(filters, 5, output_kernel_size, padding=output_padding)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)

    @staticmethod
    def _block(filters: int, pool_until: int, dropout: float, fused_tail: bool) -> nn.Module:
        return ResidualBlock(filters, pool_until=pool_until, dropout=dropout,
                             fused_tail=fused_tail)

    def grid_size(self) -> int:
        """Static output grid arithmetic (conv/pool floor semantics)."""
        pad = self.input_kernel_size - self.input_stride
        dim = (self.input_shape[0] + 2 * pad - self.input_kernel_size) // self.input_stride + 1
        for _ in range(self.num_residual_blocks):
            if dim > self.POOL_FACTOR * self.num_patches:
                dim //= 2
        return dim + 2 * self.output_padding - self.output_kernel_size + 1

    def forward(self, images: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        # an NHWC tensor seen as NCHW is in channels_last memory format
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype or self.conv1.weight.dtype)
        x = conv(self.conv1, x)
        for block in self.residual_blocks:
            x = block(x, masks)
        x = conv(self.out, self.head_dropout(x, masks))
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1).contiguous()


if __name__ == "__main__":  # smoke benchmark
    from fdtpu_torch.models.smoke import smoke_main

    smoke_main(lambda gen: PoolResnet(64, (320, 320), 15, 10, generator=gen))
