"""MobileNetV3-Small backbone grid detector (``fdtpu/models/mobilenetv3.py``).

timm's ``tf_mobilenetv3_small_100`` feature extractor (stem, eleven
inverted-residual blocks, a 1x1 conv to 576 channels; stride 32, so 480 px
gives a 15x15 grid) under a 5-channel 3x3 head and a float32 sigmoid, with
the ``tf_`` variant's semantics: TF "SAME" padding on the stem and the
depthwise convs (:func:`~fdtpu_torch.models.layers.conv_same`), BatchNorm
eps 1e-3, and timm's divisible-by-8 squeeze-excite widths. The submodule
names are fdtpu's, so its params and ``batch_stats`` map 1:1
(``compat.mobilenetv3_state_dict``) and so do the reference's TorchScript
checkpoints (``compat.torch_import``).

BatchNorm state: ``forward(images, train=False)`` normalises by the running
statistics; ``train=True`` by the batch's, and with ``update_stats`` folds
them into the running ones by Flax's rule
(:class:`~fdtpu_torch.models.layers.BatchNorm`). The model has no dropout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.models.layers import BatchNorm, conv, conv_same, lecun_normal_


def make_divisible(v: float, divisor: int = 8) -> int:
    """timm's channel rounding: nearest multiple of 8, never below 90%."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``relu6(x + 3) / 6``, in ``x``'s dtype, rounded where fdtpu rounds."""
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


class SqueezeExcite(nn.Module):
    """SE gate: mean over H and W -> 1x1 ``reduce`` (ReLU) -> 1x1 ``expand``
    (hard-sigmoid) -> scale. Both convs have biases."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, reduced, 1)
        self.expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = conv(self.expand, F.relu(conv(self.reduce, s)))
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    """MobileNetV3 bottleneck: 1x1 expand (``conv_pw``, absent when
    ``exp_ch == in_ch``) -> depthwise kxk (``conv_dw``, SAME) -> optional SE
    -> 1x1 project (``conv_pwl``), each conv bias-free and followed by its
    BatchNorm; residual when the stride is 1 and the channels match."""

    def __init__(self, in_ch: int, exp_ch: int, out_ch: int, kernel: int, stride: int,
                 use_se: bool, act: str, bn_eps: float = 1e-3):
        super().__init__()
        self.act = F.relu if act == "relu" else hard_swish
        self.residual = stride == 1 and in_ch == out_ch
        if exp_ch != in_ch:
            self.conv_pw = nn.Conv2d(in_ch, exp_ch, 1, bias=False)
            self.bn1 = BatchNorm(exp_ch, bn_eps)
        else:
            self.conv_pw = self.bn1 = None
        self.conv_dw = nn.Conv2d(exp_ch, exp_ch, kernel, stride=stride, groups=exp_ch, bias=False)
        self.bn2 = BatchNorm(exp_ch, bn_eps)
        self.se = SqueezeExcite(exp_ch, make_divisible(exp_ch * 0.25)) if use_se else None
        self.conv_pwl = nn.Conv2d(exp_ch, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch, bn_eps)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        y = x
        if self.conv_pw is not None:
            y = self.act(self.bn1(conv(self.conv_pw, y), train, update_stats))
        y = self.act(self.bn2(conv_same(self.conv_dw, y), train, update_stats))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(conv(self.conv_pwl, y), train, update_stats)
        return y + x if self.residual else y


# MobileNetV3-Small block table: (kernel, exp, out, SE, act, stride)
MOBILENETV3_SMALL: Sequence[tuple[int, int, int, bool, str, int]] = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
)


class MobileNetV3Backbone(nn.Module):
    """Args mirror fdtpu's ``MobileNetV3Backbone``, plus the port's
    ``generator`` (the weights' draws, Flax's default init: LeCun-normal
    kernels, zero biases, BatchNorm scale 1 and bias 0, running mean 0 and
    variance 1) and ``compute_dtype`` (as
    :class:`~fdtpu_torch.models.poolresnet.PoolResnet`'s).

    ``forward(images, train=False, update_stats=True)`` takes ``(B, H, W,
    3)`` images and returns the ``(B, S, S, 5)`` float32 grid map, ``S =
    H / 32``. ``num_patches`` is kept for the zoo's uniform signature; the
    grid follows from the input size.
    """

    def __init__(
        self,
        input_shape: tuple[int, int],
        num_patches: int,
        output_kernel_size: int = 3,
        bn_eps: float = 1e-3,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.num_patches = num_patches
        self.compute_dtype = compute_dtype
        self.conv_stem = nn.Conv2d(3, 16, 3, stride=2, bias=False)
        self.bn1 = BatchNorm(16, bn_eps)
        blocks, in_ch = [], 16
        for k, exp, out, se, act, s in MOBILENETV3_SMALL:
            blocks.append(InvertedResidual(in_ch, exp, out, k, s, se, act, bn_eps))
            in_ch = out
        self.blocks = nn.ModuleList(blocks)
        # the final ConvBnAct 1x1 to 576, the last stage of timm's blocks
        self.conv_576 = nn.Conv2d(in_ch, 576, 1, bias=False)
        self.bn_576 = BatchNorm(576, bn_eps)
        self.head = nn.Conv2d(576, 5, output_kernel_size, padding=1)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)

    def grid_size(self) -> int:
        return self.input_shape[0] // 32

    def forward(self, images: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype or self.conv_stem.weight.dtype)
        x = hard_swish(self.bn1(conv_same(self.conv_stem, x), train, update_stats))
        for block in self.blocks:
            x = block(x, train, update_stats)
        x = hard_swish(self.bn_576(conv(self.conv_576, x), train, update_stats))
        x = conv(self.head, x)
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1).contiguous()


if __name__ == "__main__":  # smoke benchmark
    from fdtpu_torch.models.smoke import smoke_main

    smoke_main(lambda gen: MobileNetV3Backbone((320, 320), 15, generator=gen))
