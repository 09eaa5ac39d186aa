"""RetinaFace with a ResNet-50 backbone (Deng et al., "RetinaFace:
Single-stage Dense Face Localisation in the Wild", arXiv:1905.00641), as
``cfg_re50`` of github.com/biubug6/Pytorch_Retinaface builds it
(``models/retinaface.py``, ``models/net.py``).

* ``body``: torchvision's ResNet-50 (bottlenecks 3-4-6-3, the stride on the
  3x3, BatchNorm after every convolution), of which ``layer2``, ``layer3``
  and ``layer4`` feed the pyramid (``in_channels``, 512, 1024 and 2048 at
  the published widths);
* ``fpn``: 1x1 laterals (conv, BatchNorm, activation) to ``out_channel``;
  the coarser level upsampled (nearest) to the finer one's size, added, and
  merged by a 3x3 conv, BatchNorm and activation;
* ``ssh1``-``ssh3``: one context module a level, a 3x3 to ``out/2`` beside
  a 3x3 to ``out/4`` followed by a 3x3 and by a chain of two, each with
  BatchNorm; the three concatenated, then ReLU;
* ``ClassHead``, ``BboxHead``, ``LandmarkHead``: a 1x1 convolution a level,
  two anchors a location (4, 8 and 20 channels).

The activation is ReLU, or LeakyReLU(0.1) where ``out_channel`` is 64 or
less (``net.py``'s rule). Submodule names follow the published model, so
its ``state_dict`` names are these (the port's BatchNorm keeps no
``num_batches_tracked``). BatchNorm is the port's :class:`BatchNorm` with
``nn.BatchNorm2d``'s epsilon, 1e-5; served, it normalises by the running
statistics. Weights start from torch's default init of a convolution.

``forward`` takes ``(B, H, W, 3)`` RGB images in [0, 1], as every family's,
and applies the published input transform first, in float32: to BGR, times
255, less the BGR ``mean`` (104, 117, 123); then it computes in
``compute_dtype`` (or the weights' dtype). The heads' outputs are cast to
float32 before the softmax and the decode. It returns ``(B, N, 15)``
float32 rows ``[face score, x0, y0, w, h, l1x, l1y, ..., l5x, l5y]``, box
and points normalised to the image, one row a prior in
``prior_box.py``'s order (``core/priors.py``: level, row, column, anchor).
The stem and the heads go through ``layers.narrow_conv``. Each convolution's
BatchNorm, with the residual add and the activation after it, goes through
``layers.bn_act``: served on a card, one fused launch a BatchNorm (73 at
the published widths). SSH's ReLU after its ``cat`` runs as each branch's
activation (ReLU after ``cat`` is ReLU on each branch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.core.priors import anchors_on, decode_boxes, decode_landmarks, feature_maps
from fdtpu_torch.models.layers import BatchNorm, bn_act, conv, narrow_conv, torch_uniform_

BLOCKS = (3, 4, 6, 3)  # ResNet-50's bottlenecks a stage
BN_EPS = 1e-5  # nn.BatchNorm2d's
ROW = 15  # [score, x0, y0, w, h, five points]
RELU = 0.0  # layers.bn_act's activation for ReLU


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS)


class Bottleneck(nn.Module):
    """torchvision's ResNet-50 bottleneck: 1x1, 3x3 (the stride), 1x1 to
    four times ``planes``, each with BatchNorm; a 1x1 projection with
    BatchNorm (``downsample``) where the shape changes; ReLU after the sum."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = _bn(4 * planes)
        self.downsample = None
        if stride != 1 or cin != 4 * planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * planes, 1, stride, bias=False),
                                            _bn(4 * planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_act(self.bn1, conv(self.conv1, x), RELU)
        y = bn_act(self.bn2, conv(self.conv2, y), RELU)
        skip = x if self.downsample is None else bn_act(self.downsample[1],
                                                        conv(self.downsample[0], x))
        return bn_act(self.bn3, conv(self.conv3, y), RELU, skip)


class ResNetBody(nn.Module):
    """The stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max-pool) and the four
    stages; ``forward`` returns ``layer2``-``layer4``'s outputs. The
    widths follow ``in_channels``: ``layer1`` has a quarter of ``layer2``'s
    planes, and each stage's output is four times its planes."""

    def __init__(self, in_channels: tuple[int, int, int]):
        super().__init__()
        planes = (in_channels[0] // 8, in_channels[0] // 4, in_channels[1] // 4,
                  in_channels[2] // 4)
        self.conv1 = nn.Conv2d(3, planes[0], 7, 2, 3, bias=False)
        self.bn1 = _bn(planes[0])
        cin = planes[0]
        for i, (p, n) in enumerate(zip(planes, BLOCKS)):
            blocks = [Bottleneck(cin, p, 1 if i == 0 else 2)]
            blocks += [Bottleneck(4 * p, p, 1) for _ in range(n - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin = 4 * p

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        # a stem narrower than a multiple of 8 comes from conv_gemm as a channel
        # slice of a padded output; the epilogue takes dense rows (a no-op at 64)
        x = narrow_conv(self.conv1, x).contiguous(memory_format=torch.channels_last)
        x = bn_act(self.bn1, x, RELU)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = block(x)
            if i > 1:
                outs.append(x)
        return outs


class ConvBN(nn.Sequential):
    """``net.py``'s ``conv_bn`` family: a bias-free convolution (``.0``)
    and BatchNorm (``.1``), then ``act`` (``layers.bn_act``'s)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(nn.Conv2d(cin, cout, k, 1, k // 2, bias=False), _bn(cout))

    def forward(self, x: torch.Tensor, act: float | None = None) -> torch.Tensor:
        return bn_act(self[1], conv(self[0], x), act)


class FPN(nn.Module):
    """``net.py``'s ``FPN``: laterals ``output1``-``output3``, merges
    ``merge1``, ``merge2``."""

    def __init__(self, in_channels: tuple[int, int, int], out: int, leaky: float):
        super().__init__()
        self.leaky = leaky
        for i, cin in enumerate(in_channels):
            setattr(self, f"output{i + 1}", ConvBN(cin, out, 1))
        self.merge1 = ConvBN(out, out, 3)
        self.merge2 = ConvBN(out, out, 3)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        o1, o2, o3 = (getattr(self, f"output{i + 1}")(f, self.leaky)
                      for i, f in enumerate(feats))
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"), self.leaky)
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"), self.leaky)
        return [o1, o2, o3]


class SSH(nn.Module):
    """``net.py``'s ``SSH`` context module."""

    def __init__(self, cin: int, out: int, leaky: float):
        super().__init__()
        if out % 4:
            raise ValueError(f"SSH needs out_channel divisible by 4, got {out}")
        self.leaky = leaky
        self.conv3X3 = ConvBN(cin, out // 2, 3)
        self.conv5X5_1 = ConvBN(cin, out // 4, 3)
        self.conv5X5_2 = ConvBN(out // 4, out // 4, 3)
        self.conv7X7_2 = ConvBN(out // 4, out // 4, 3)
        self.conv7x7_3 = ConvBN(out // 4, out // 4, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x, self.leaky)
        c7_2 = self.conv7X7_2(c5_1, self.leaky)
        # ReLU after the cat, as each branch's activation
        return torch.cat([self.conv3X3(x, RELU), self.conv5X5_2(c5_1, RELU),
                          self.conv7x7_3(c7_2, RELU)], dim=1)


class Head(nn.Module):
    """One level's 1x1 head (``ClassHead``, ``BboxHead``,
    ``LandmarkHead``): ``(B, C, H, W)`` -> ``(B, H W anchors, width)``
    float32, NHWC row-major as the published ``permute`` and ``view``."""

    def __init__(self, cin: int, anchors: int, width: int):
        super().__init__()
        self.width = width
        self.conv1x1 = nn.Conv2d(cin, anchors * width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = narrow_conv(self.conv1x1, x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.width).float()


class RetinaFace(nn.Module):
    """Args are ``cfg_re50``'s keys (``utils.config.RetinaFaceConfig``)."""

    def __init__(
        self,
        input_shape: tuple[int, int] = (840, 840),  # (height, width)
        in_channels: tuple[int, int, int] = (512, 1024, 2048),
        out_channel: int = 256,
        min_sizes: tuple[tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512)),
        steps: tuple[int, ...] = (8, 16, 32),
        variance: tuple[float, float] = (0.1, 0.2),
        clip: bool = False,
        mean: tuple[float, float, float] = (104.0, 117.0, 123.0),
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_shape = tuple(input_shape)
        self.min_sizes = tuple(tuple(s) for s in min_sizes)
        self.steps = tuple(steps)
        self.variance = tuple(variance)
        self.clip = clip
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32), persistent=False)
        leaky = 0.1 if out_channel <= 64 else 0.0
        anchors = len(self.min_sizes[0])
        self.body = ResNetBody(tuple(in_channels))
        self.fpn = FPN(tuple(in_channels), out_channel, leaky)
        for i in range(1, 4):
            setattr(self, f"ssh{i}", SSH(out_channel, out_channel, leaky))
        self.ClassHead = nn.ModuleList(Head(out_channel, anchors, 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(out_channel, anchors, 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(out_channel, anchors, 10) for _ in range(3))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                torch_uniform_(m, m.weight[0].numel(), generator)

    def num_priors(self) -> int:
        return len(self.min_sizes[0]) * sum(r * c for r, c in
                                             feature_maps(self.input_shape, self.steps))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # to BGR, 0-255, less the mean; an NHWC tensor seen as NCHW is channels_last
        x = (images.flip(-1) * 255.0 - self.mean).permute(0, 3, 1, 2)
        x = x.to(self.compute_dtype or self.body.conv1.weight.dtype)
        feats = self.fpn(self.body(x))
        feats = [getattr(self, f"ssh{i + 1}")(f) for i, f in enumerate(feats)]
        want = feature_maps(tuple(images.shape[1:3]), self.steps)
        if [tuple(f.shape[2:]) for f in feats] != want:
            raise ValueError(f"feature maps {[tuple(f.shape[2:]) for f in feats]} != the "
                             f"priors' {want}")
        cls, loc, ldm = (torch.cat([head(f) for head, f in zip(heads, feats)], dim=1)
                         for heads in (self.ClassHead, self.BboxHead, self.LandmarkHead))
        priors = anchors_on(self.min_sizes, self.steps, tuple(images.shape[1:3]), self.clip,
                            cls.device)
        score = torch.softmax(cls, dim=-1)[..., 1:]
        return torch.cat([score, decode_boxes(loc, priors, self.variance),
                          decode_landmarks(ldm, priors, self.variance)], dim=-1)
