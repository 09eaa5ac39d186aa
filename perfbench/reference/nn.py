"""Layers of the plain references: float32 convolutions and linear layers,
LeakyReLU(0.2), 2x2 max-pool, channel dropout from drawn masks, and the
precision a reference computes its layers in.

:class:`Precision` ``"float32"`` is the reference. ``"float8"`` is the
control of a configuration that states bfloat16 compute: wherever the
program holds a tensor in bfloat16 (every convolution's and linear
layer's input, weight and output, each activation, dropout's output and
the residual sum) it is rounded to float8 e4m3 on the way forward, and
every gradient that flows back through those points on the way back,
each tensor scaled by its largest magnitude onto float8's range first
(448), as float8 training scales its tensors; the products are summed in
float32. ``"bfloat16"`` rounds the same
tensors to bfloat16 (a diagnostic: it should read as the program does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FLOAT8_MAX = 448.0  # the largest finite float8 e4m3fn


def quantize(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return x.to(torch.bfloat16).float()
    scale = FLOAT8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).clamp(-FLOAT8_MAX, FLOAT8_MAX).to(torch.float8_e4m3fn).float() / scale


class _Round(torch.autograd.Function):
    """Rounds a tensor on the way forward and its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return quantize(x, name)

    @staticmethod
    def backward(ctx, grad):
        return quantize(grad, ctx.name), None


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the precision, and its gradient on the way
        back."""
        if self.name == "float32":
            return x
        return _Round.apply(x, self.name)


FLOAT32 = Precision("float32")


def conv(x, w, b, prec: Precision, stride: int = 1, padding: int = 0):
    y = F.conv2d(prec.round(x), prec.round(w), None, stride, padding)
    if b is not None:
        y = y + b[None, :, None, None]
    return prec.round(y)


def linear(x, w, b, prec: Precision):
    return prec.round(F.linear(prec.round(x), prec.round(w), b))


def leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def max_pool(x):
    return F.max_pool2d(x, 2, 2)


class Masks:
    """Channel-dropout keep masks drawn from a generator in call order, as
    the program draws them (``torch.rand((B, C, 1, 1)) < 1 - rate``), and
    replayed after :meth:`rewind` (both SAM points see the same masks)."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator
        self.masks: list[torch.Tensor] = []
        self.next = 0

    def rewind(self) -> None:
        self.next = 0

    def apply(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        shape = (x.shape[0], x.shape[1], 1, 1)
        if self.next == len(self.masks):
            u = torch.rand(shape, generator=self.generator, device=x.device)
            self.masks.append(u < 1.0 - rate)
        keep = self.masks[self.next]
        self.next += 1
        return torch.where(keep, x / (1.0 - rate), 0.0)


NO_DROPOUT = Masks(None)
