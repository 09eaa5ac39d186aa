"""Shared building blocks (``fdtpu/models/layers.py``), NCHW inside.

Convolutions and pooling go to cuDNN (or oneDNN on the CPU) through
``torch.nn.functional``, as XLA handled them in fdtpu. Weights start from
fdtpu's Flax defaults (LeCun-normal kernels, zero biases), the SSD's from
torch's default init as fdtpu's SSD does, drawn from an explicit
``torch.Generator``. A convolution computes in its input's dtype,
casting its weights to it (Flax's ``dtype=`` with float32 params).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.kernels.epilogue import fused_residual_tail


class DropoutMasks:
    """The channel masks of one forward's dropout layers, drawn from an
    explicit ``torch.Generator`` (on the activations' device) in call order.

    fdtpu evaluates both SAM points with one dropout key, so both see the
    same masks: :meth:`rewind` before the second forward replays the masks
    the first one drew instead of drawing new ones.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._masks: list[torch.Tensor] = []
        self._next = 0

    def rewind(self) -> None:
        self._next = 0

    def keep(self, shape: tuple[int, ...], rate: float, device: torch.device) -> torch.Tensor:
        """The next bool keep-mask of ``shape``, each entry kept with
        probability ``1 - rate``: drawn the first time, replayed after
        :meth:`rewind`."""
        if self._next == len(self._masks):
            u = torch.rand(shape, generator=self.generator, device=device)
            self._masks.append(u < 1.0 - rate)
        mask = self._masks[self._next]
        if mask.shape != shape:
            raise ValueError(f"replayed mask {tuple(mask.shape)} does not fit {shape}")
        self._next += 1
        return mask


class Dropout2d(nn.Module):
    """Channel dropout with fdtpu's semantics (``nn.Dropout`` with
    ``broadcast_dims=(1, 2)``): whole channels of each sample are zeroed and
    survivors divided by ``1 - rate``. It applies only when the forward is
    given :class:`DropoutMasks`; without them it is the identity, as fdtpu's
    ``train=False``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        if masks is None or self.rate == 0.0:
            return x
        keep = masks.keep((x.shape[0], x.shape[1], 1, 1), self.rate, x.device)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def conv(layer: nn.Conv2d, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype: the weights are cast to it (a
    no-op when they already have it), the params stay as they are. Without
    ``with_bias`` the layer's bias is left for the caller to add."""
    bias = layer.bias.to(x.dtype) if with_bias and layer.bias is not None else None
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride, layer.padding)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the reference's 0.2 slope."""
    return F.leaky_relu(x, negative_slope=0.2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with floor semantics, like ``nn.MaxPool2d(2)``."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def lecun_normal_(conv: nn.Conv2d | nn.Linear, generator: torch.Generator | None = None) -> None:
    """Flax's default conv (and Dense) init in place: kernel ~ truncated
    normal (2 std) with variance ``1 / fan_in``, bias 0."""
    fan_in = conv.weight[0].numel()  # in_channels / groups * kh * kw, or in_features
    # 0.8796... is the std of a unit normal truncated to [-2, 2] (as in
    # jax.nn.initializers.variance_scaling)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def torch_uniform_(layer: nn.Conv2d | nn.Linear, fan_in: int,
                   generator: torch.Generator | None = None) -> None:
    """torch's default ``nn.Conv2d``/``nn.Linear`` init in place, as fdtpu's
    ``torch_conv_inits``: kernel and bias both ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))`` (``kaiming_uniform(a=sqrt(5))`` reduces to that bound),
    drawn from ``generator``. ``fan_in`` = in_channels * kh * kw (in_features
    for a Linear)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)


def ssd_init_(layer: nn.Conv2d | nn.Linear, torch_init: bool,
              generator: torch.Generator | None = None) -> None:
    """The SSD's init of one layer: torch's default with ``torch_init``
    (fdtpu's SSD default), else fdtpu's LeCun-normal."""
    if torch_init:
        torch_uniform_(layer, layer.weight[0].numel(), generator)
    else:
        lecun_normal_(layer, generator)


class SSDResidualBlock(nn.Module):
    """The SSD model's block (fdtpu's ``SSDResidualBlock``)::

        conv3x3 -> leaky(0.2) -> conv3x3 -> leaky -> dropout2d -> + skip
        -> 2x2 max-pool if use_max_pool

    The skip is a 1x1 projection (``skip``) when the channel counts differ,
    the identity otherwise. Weights start from torch's default init with
    ``torch_init`` (fdtpu's SSD default), else from fdtpu's LeCun-normal.
    fdtpu's ``fold_width`` lowering is left out: a TPU lowering of the same
    convolutions.
    """

    def __init__(self, in_filters: int, out_filters: int, use_max_pool: bool = False,
                 dropout: float = 0.25, torch_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.skip = nn.Conv2d(in_filters, out_filters, 1) if in_filters != out_filters else None
        self.conv1 = nn.Conv2d(in_filters, out_filters, 3, padding=1)
        self.conv2 = nn.Conv2d(out_filters, out_filters, 3, padding=1)
        self.dropout = Dropout2d(dropout)
        for layer in (self.skip, self.conv1, self.conv2):
            if layer is not None:
                ssd_init_(layer, torch_init, generator)

    def forward(self, x: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        skip = x if self.skip is None else conv(self.skip, x)
        x = leaky_relu(conv(self.conv1, x))
        x = self.dropout(leaky_relu(conv(self.conv2, x)), masks) + skip
        if self.use_max_pool:
            x = max_pool_2x2(x)
        return x


class ResidualBlock(nn.Module):
    """The reference's residual block::

        conv3x3 -> leaky(0.2) -> conv3x3 -> leaky -> dropout2d(0.25) -> +skip
        -> maxpool while the spatial height > pool_until

    Submodule names ``conv1``/``conv2`` follow the reference torch model.

    ``fused_tail`` (eval only) runs ``leaky -> +skip -> maxpool`` as one
    launch of the fused residual-tail kernel (``kernels/epilogue.py``),
    bit-equal to the eager tail: fdtpu's ``TailBlock(mode="pallas")`` of
    ``scripts/bench_pool_fusion.py``. On the card the kernel also adds
    ``conv2``'s bias: cuDNN's convolution leaves it to a separate
    elementwise pass, whose rounding the kernel repeats. On the CPU oneDNN
    adds the bias inside the convolution and rounds once, so there it stays
    in the convolution. With dropout masks it raises, and so does the kernel
    under autograd.
    """

    def __init__(self, filters: int, pool_until: int, dropout: float = 0.25,
                 fused_tail: bool = False):
        super().__init__()
        self.pool_until = pool_until
        self.fused_tail = fused_tail
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.dropout = Dropout2d(dropout)

    def forward(self, x: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        skip = x
        x = leaky_relu(conv(self.conv1, x))
        if self.fused_tail:
            if masks is not None:
                raise ValueError("fused_tail is eval-only: the forward was given dropout masks")
            pool = x.shape[2] > self.pool_until
            # dropout is the identity at eval
            if x.device.type == "cuda" and self.conv2.bias is not None:
                c2 = conv(self.conv2, x, with_bias=False)
                return fused_residual_tail(c2, skip, pool=pool, bias=self.conv2.bias.to(x.dtype))
            return fused_residual_tail(conv(self.conv2, x), skip, pool=pool)
        x = conv(self.conv2, x)
        x = self.dropout(leaky_relu(x), masks) + skip
        if x.shape[2] > self.pool_until:  # NCHW: dim 2 is the height
            x = max_pool_2x2(x)
        return x
