"""Shared building blocks (``fdtpu/models/layers.py``), NCHW inside.

Convolutions and pooling go to cuDNN (or oneDNN on the CPU) through
``torch.nn.functional``, as XLA handled them in fdtpu. Weights start from
fdtpu's Flax defaults (LeCun-normal kernels, zero biases), drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# torch's nn.Dropout2d has fdtpu's Dropout2d semantics: it zeroes whole
# channels per sample and rescales survivors by 1/(1 - rate); identity in eval.
Dropout2d = nn.Dropout2d


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the reference's 0.2 slope."""
    return F.leaky_relu(x, negative_slope=0.2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with floor semantics, like ``nn.MaxPool2d(2)``."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def lecun_normal_(conv: nn.Conv2d, generator: torch.Generator | None = None) -> None:
    """Flax's default conv init in place: kernel ~ truncated normal (2 std)
    with variance ``1 / fan_in``, bias 0."""
    fan_in = conv.in_channels // conv.groups * math.prod(conv.kernel_size)
    # 0.8796... is the std of a unit normal truncated to [-2, 2] (as in
    # jax.nn.initializers.variance_scaling)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class ResidualBlock(nn.Module):
    """The reference's residual block::

        conv3x3 -> leaky(0.2) -> conv3x3 -> leaky -> dropout2d(0.25) -> +skip
        -> maxpool while the spatial height > pool_until

    Submodule names ``conv1``/``conv2`` follow the reference torch model.
    """

    def __init__(self, filters: int, pool_until: int, dropout: float = 0.25):
        super().__init__()
        self.pool_until = pool_until
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.dropout = Dropout2d(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        x = leaky_relu(self.conv1(x))
        x = leaky_relu(self.conv2(x))
        x = self.dropout(x) + skip
        if x.shape[2] > self.pool_until:  # NCHW: dim 2 is the height
            x = max_pool_2x2(x)
        return x
