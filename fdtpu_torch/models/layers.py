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


def conv(layer: nn.Conv2d, x: torch.Tensor, with_bias: bool = True,
         padding: tuple[int, int] | None = None) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype: the weights are cast to it (a
    no-op when they already have it), the params stay as they are. Without
    ``with_bias`` the layer's bias is left for the caller to add;
    ``padding`` replaces the layer's own."""
    bias = layer.bias.to(x.dtype) if with_bias and layer.bias is not None else None
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding if padding is None else padding, layer.dilation, layer.groups)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF/Flax ``"SAME"`` padding of one spatial dim of size ``n`` for a
    ``k``-tap stride-``s`` convolution: ``ceil(n / s)`` outputs, the total
    pad split with its smaller half before (``lax.padtype_to_pads``)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` with ``"SAME"`` padding, as Flax pads it. A strided layer
    often pads one more row or column after than before (a k3/s2 conv at
    480 px pads (0, 1)), which ``nn.Conv2d(padding=k // 2)`` gets wrong and
    ``padding="same"`` refuses: the input is zero-padded first, and the
    convolution pads nothing. Symmetric pads go to the convolution."""
    k, s = layer.kernel_size[0], layer.stride[0]
    (top, bottom), (left, right) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if top == bottom and left == right:
        return conv(layer, x, padding=(top, left))
    return conv(layer, F.pad(x, (left, right, top, bottom)), padding=(0, 0))


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


class SeparableResidualBlock(nn.Module):
    """fdtpu's depthwise-separable residual block (SeparableCNN's)::

        pointwise1x1 -> leaky -> depthwise3x3 -> leaky -> pointwise1x1
        -> dropout2d -> +skip -> maxpool while the spatial height > pool_until

    No conv has a bias. Submodule names follow the reference torch model:
    ``pointwise_conv1``, ``depthwise_conv`` (one group a channel),
    ``pointwise_conv2``.
    """

    def __init__(self, filters: int, pool_until: int, dropout: float = 0.25):
        super().__init__()
        self.pool_until = pool_until
        self.pointwise_conv1 = nn.Conv2d(filters, filters, 1, bias=False)
        self.depthwise_conv = nn.Conv2d(filters, filters, 3, padding=1, groups=filters, bias=False)
        self.pointwise_conv2 = nn.Conv2d(filters, filters, 1, bias=False)
        self.dropout = Dropout2d(dropout)

    def forward(self, x: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        skip = x
        x = leaky_relu(conv(self.pointwise_conv1, x))
        x = leaky_relu(conv(self.depthwise_conv, x))
        x = self.dropout(conv(self.pointwise_conv2, x), masks) + skip
        if x.shape[2] > self.pool_until:
            x = max_pool_2x2(x)
        return x


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channels of an NCHW tensor: params
    ``weight`` (Flax's ``scale``) and ``bias``, buffers ``running_mean`` and
    ``running_var`` (Flax's ``batch_stats``), all float32 whatever the
    input's dtype (a bfloat16 input is normalised in float32 and rounded
    once, as Flax's ``dtype=bfloat16``).

    ``train`` is an argument, as in fdtpu, not ``nn.Module.training``: with
    it the layer normalises by the batch's mean and biased variance,
    without it by the running statistics; both through ``F.batch_norm``
    (one fused kernel each way on the card). With ``train`` and
    ``update_stats`` it also folds the batch's statistics into the running
    ones by Flax's rule, which is not ``nn.BatchNorm2d``'s: ``running =
    momentum * running + (1 - momentum) * batch`` with ``momentum`` 0.99 on
    the running side, and Flax's variance ``E[x^2] - E[x]^2`` (clipped at
    0, reduced in float32). ``nn.BatchNorm2d`` would fold in the unbiased
    variance (1% larger at 100 values a channel) and count
    ``num_batches_tracked``, which this layer has not.
    """

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        if train and update_stats:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean((0, 2, 3))
                var = (xf.square().mean((0, 2, 3)) - mean.square()).clamp_min(0.0)
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        if train:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)
