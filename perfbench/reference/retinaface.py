"""RetinaFace-R50 (Deng et al., "RetinaFace: Single-stage Dense Face
Localisation in the Wild", arXiv:1905.00641) as ``cfg_re50`` of
github.com/biubug6/Pytorch_Retinaface builds it (``models/retinaface.py``,
``models/net.py``, ``layers/functions/prior_box.py``, ``utils/box_utils.py``,
``detect.py``), in plain float32 PyTorch.

torchvision's ResNet-50 (a 7x7/2 stem with BatchNorm, ReLU and a 3x3/2
max-pool; bottlenecks 3-4-6-3 with the stride on the 3x3 and a 1x1
projection where the shape changes), whose ``layer2``-``layer4`` feed an
FPN (1x1 laterals with BatchNorm and activation; the coarser level
upsampled to the finer one's size by nearest neighbour, added, merged by a
3x3 with BatchNorm and activation), one SSH module a level (a 3x3 to half
the width beside a 3x3 to a quarter followed by one 3x3 and by a chain of
two, all with BatchNorm, concatenated, then ReLU) and three 1x1 heads a
level (class 2 x 2, box 2 x 4, landmarks 2 x 10). The activation is ReLU,
or LeakyReLU(0.1) where ``out_channel`` is 64 or less. BatchNorm divides
by ``sqrt(running_var + 1e-5)``. Scores are the softmax's face column;
boxes and points are decoded from the priors with variances (0.1, 0.2).

Departures from the published code, each the port's rule:

* the input is an RGB image in [0, 1] (the harness's frames over 255):
  it is put in BGR order, times 255, less the BGR mean; the published
  code subtracts the mean from the uint8 values, which ``k / 255 * 255``
  meets to a float32 rounding;
* a row is ``[score, x0, y0, w, h, l1x, l1y, ..., l5x, l5y]``, the box as
  its corner and size (the published decode gives the two corners);
* a candidate's corners are rounded to whole pixels
  (``serve.linear_candidates``, K1's rule for every family); the published
  code keeps them fractional and measures areas with a pixel added
  (``py_cpu_nms``);
* NMS is greedy over every candidate above the served threshold
  (``detect.py``'s ``vis_thres``, 0.6), at most ``keep_top_k`` (750) kept.
  The published code runs NMS over the candidates above 0.02 and shows
  those above 0.6: the same boxes above 0.6, since a candidate is only
  suppressed by a higher score; its top-5,000 cut before NMS never binds
  at this load.

Weights: torch's default init of a convolution (``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``, kernels and the heads' biases), but the class heads'
kernels, which are unit normals truncated at 2 (``lecun_normal`` at a
fan-in of 1): under the default their face logits spread by about 0.25
(std), so that centring the scores on 50 candidates a frame above 0.5
would leave almost none above the served 0.6; at this draw they spread
by about 3.5, and roughly three in five of those above 0.5 are above 0.6
(at 480 px on the CPU). BatchNorm's scale and running variance are 1, its
shift and running mean 0.
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F

from perfbench.reference.nn import FLOAT32, NO_DROPOUT, Masks, Precision, conv
from perfbench.reference.serve import linear_candidates

ROW = 15  # [score, x0, y0, w, h, five points], normalised
TINY = dict(input_shape=[64, 64], in_channels=[32, 64, 128], out_channel=72)  # full depth
BLOCKS = (3, 4, 6, 3)  # ResNet-50
BN_EPS = 1e-5
WIDTHS = {"ClassHead": 2, "BboxHead": 4, "LandmarkHead": 10}

TRAINING = ("RetinaFace's training is not ported: it needs five-point landmark "
            "annotations and the MultiBox loss with landmark smooth-L1")


def _planes(model: dict) -> tuple[int, int, int, int]:
    c = model["in_channels"]
    return c[0] // 8, c[0] // 4, c[1] // 4, c[2] // 4


def _leaky(model: dict) -> float:
    return 0.1 if model["out_channel"] <= 64 else 0.0


def _anchors(model: dict) -> int:
    return len(model["min_sizes"][0])


def _convs(model: dict) -> list[tuple[str, int, int, int, bool]]:
    """``(name, cout, cin, k, bias)`` of every convolution; each but the
    heads' is followed by a BatchNorm of the same name's prefix."""
    out = [("body.conv1", _planes(model)[0], 3, 7, False)]
    cin = _planes(model)[0]
    for i, (p, n) in enumerate(zip(_planes(model), BLOCKS)):
        for j in range(n):
            name = f"body.layer{i + 1}.{j}"
            out += [(f"{name}.conv1", p, cin, 1, False), (f"{name}.conv2", p, p, 3, False),
                    (f"{name}.conv3", 4 * p, p, 1, False)]
            if j == 0:
                out.append((f"{name}.downsample.0", 4 * p, cin, 1, False))
            cin = 4 * p
    w = model["out_channel"]
    out += [(f"fpn.output{i + 1}.0", w, c, 1, False) for i, c in enumerate(model["in_channels"])]
    out += [("fpn.merge1.0", w, w, 3, False), ("fpn.merge2.0", w, w, 3, False)]
    for i in range(1, 4):
        out += [(f"ssh{i}.conv3X3.0", w // 2, w, 3, False),
                (f"ssh{i}.conv5X5_1.0", w // 4, w, 3, False),
                (f"ssh{i}.conv5X5_2.0", w // 4, w // 4, 3, False),
                (f"ssh{i}.conv7X7_2.0", w // 4, w // 4, 3, False),
                (f"ssh{i}.conv7x7_3.0", w // 4, w // 4, 3, False)]
    for head, width in WIDTHS.items():
        out += [(f"{head}.{i}.conv1x1", _anchors(model) * width, w, 1, True) for i in range(3)]
    return out


def _bn_name(conv_name: str) -> str:
    """The BatchNorm after a convolution: ``bnN`` beside ``convN`` in the
    ResNet, the next index in a ``Sequential``."""
    if conv_name.endswith(".0"):
        return conv_name[:-1] + "1"
    head, _, last = conv_name.rpartition(".conv")
    return f"{head}.bn{last}"


def param_specs(model: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, (initialiser, fan_in))`` of every parameter and
    BatchNorm statistic, named as the program's ``state_dict`` (the
    published model's names)."""
    specs = []
    for name, cout, cin, k, bias in _convs(model):
        fan_in = cin * k * k
        init = ("lecun_normal", 1) if name.startswith("ClassHead.") else ("torch_uniform", fan_in)
        specs.append((f"{name}.weight", (cout, cin, k, k), init))
        if bias:
            specs.append((f"{name}.bias", (cout,), ("torch_uniform", fan_in)))
            continue
        bn = _bn_name(name)
        specs += [(f"{bn}.weight", (cout,), ("ones", 0)), (f"{bn}.bias", (cout,), ("zeros", 0)),
                  (f"{bn}.running_mean", (cout,), ("zeros", 0)),
                  (f"{bn}.running_var", (cout,), ("ones", 0))]
    return specs


def feature_maps(model: dict) -> list[tuple[int, int]]:
    """Each level's ``(rows, cols)``: ``prior_box.py``'s ``ceil(size /
    step)``."""
    h, w = model["input_shape"]
    return [(-(-h // s), -(-w // s)) for s in model["steps"]]


@functools.lru_cache(maxsize=8)
def _priors_cpu(min_sizes: tuple, steps: tuple, size: tuple, maps: tuple,
                clip: bool) -> torch.Tensor:
    h, w = size
    anchors = []
    for k, (rows, cols) in enumerate(maps):
        for i, j in itertools.product(range(rows), range(cols)):
            for min_size in min_sizes[k]:
                anchors += [(j + 0.5) * steps[k] / w, (i + 0.5) * steps[k] / h,
                            min_size / w, min_size / h]
    out = torch.tensor(anchors, dtype=torch.float32).view(-1, 4)
    return out.clamp(0.0, 1.0) if clip else out


def priors(model: dict, device) -> torch.Tensor:
    """``(N, 4)`` priors ``[cx, cy, s_kx, s_ky]``, ``prior_box.py``'s loop:
    level, row, column, ``min_size``."""
    key = (tuple(tuple(s) for s in model["min_sizes"]), tuple(model["steps"]),
           tuple(model["input_shape"]), tuple(feature_maps(model)), bool(model["clip"]))
    return _priors_cpu(*key).to(device)


def _bn(x, p: dict, name: str, prec: Precision):
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + BN_EPS)
    y = (x - p[f"{name}.running_mean"][:, None, None]) * scale[:, None, None]
    return prec.round(y + p[f"{name}.bias"][:, None, None])


def _conv_bn(x, p: dict, name: str, prec: Precision, stride: int = 1):
    k = p[f"{name}.weight"].shape[-1]
    return _bn(conv(x, p[f"{name}.weight"], None, prec, stride, k // 2), p, _bn_name(name), prec)


def _act(x, leaky: float, prec: Precision):
    return prec.round(F.leaky_relu(x, leaky)) if leaky else F.relu(x)


def forward(params: dict, images: torch.Tensor, model: dict, prec: Precision = FLOAT32,
            masks: Masks = NO_DROPOUT) -> torch.Tensor:
    """``images`` ``(B, H, W, 3)`` RGB in [0, 1] -> ``(B, N, 15)`` rows.
    ``masks`` is unused: the model has no dropout."""
    p, leaky = params, _leaky(model)
    mean = torch.tensor(model["mean"], dtype=torch.float32, device=images.device)
    x = (images[..., [2, 1, 0]] * 255.0 - mean).permute(0, 3, 1, 2)
    x = F.relu(_bn(conv(x, p["body.conv1.weight"], None, prec, 2, 3), p, "body.bn1", prec))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for i, n in enumerate(BLOCKS):
        for j in range(n):
            name = f"body.layer{i + 1}.{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(_conv_bn(x, p, f"{name}.conv1", prec))
            y = F.relu(_conv_bn(y, p, f"{name}.conv2", prec, stride))
            y = _conv_bn(y, p, f"{name}.conv3", prec)
            skip = x if j else _bn(conv(x, p[f"{name}.downsample.0.weight"], None, prec, stride),
                                   p, f"{name}.downsample.1", prec)
            x = F.relu(prec.round(y + skip))
        if i > 0:
            feats.append(x)

    o1, o2, o3 = (_act(_conv_bn(f, p, f"fpn.output{i + 1}.0", prec), leaky, prec)
                  for i, f in enumerate(feats))
    o2 = _act(_conv_bn(prec.round(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest")),
                       p, "fpn.merge2.0", prec), leaky, prec)
    o1 = _act(_conv_bn(prec.round(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest")),
                       p, "fpn.merge1.0", prec), leaky, prec)

    rows = {head: [] for head in WIDTHS}
    for lvl, f in enumerate((o1, o2, o3)):
        s = f"ssh{lvl + 1}"
        c5_1 = _act(_conv_bn(f, p, f"{s}.conv5X5_1.0", prec), leaky, prec)
        c7_2 = _act(_conv_bn(c5_1, p, f"{s}.conv7X7_2.0", prec), leaky, prec)
        f = F.relu(torch.cat([_conv_bn(f, p, f"{s}.conv3X3.0", prec),
                              _conv_bn(c5_1, p, f"{s}.conv5X5_2.0", prec),
                              _conv_bn(c7_2, p, f"{s}.conv7x7_3.0", prec)], dim=1))
        if tuple(f.shape[2:]) != feature_maps(model)[lvl]:
            raise ValueError(f"level {lvl}: {tuple(f.shape[2:])} != {feature_maps(model)[lvl]}")
        for head, width in WIDTHS.items():
            z = conv(f, p[f"{head}.{lvl}.conv1x1.weight"], p[f"{head}.{lvl}.conv1x1.bias"], prec)
            rows[head].append(z.permute(0, 2, 3, 1).reshape(z.shape[0], -1, width))
    cls, loc, ldm = (torch.cat(rows[head], dim=1) for head in WIDTHS)

    pri = priors(model, images.device)
    v0, v1 = model["variance"]
    centre = pri[:, :2] + loc[..., :2] * v0 * pri[:, 2:]
    size = pri[:, 2:] * torch.exp(loc[..., 2:] * v1)
    points = [pri[:, :2] + ldm[..., 2 * q:2 * q + 2] * v0 * pri[:, 2:] for q in range(5)]
    score = F.softmax(cls, dim=-1)[..., 1:]
    return torch.cat([score, centre - size / 2, size, *points], dim=-1)


def flop_counts(model: dict) -> tuple[float, float]:
    """-> ``(forward FLOPs, the stem's)`` of one image: 2 a multiply-add of
    every convolution at its output size (BatchNorm, activations, the
    upsampling, the softmax and the decode are left out)."""
    h, w = model["input_shape"]

    def out(n, k, s, pad):
        return (n + 2 * pad - k) // s + 1

    def flops(hw, cout, cin, k):
        return 2.0 * hw[0] * hw[1] * cout * cin * k * k

    size = (out(h, 7, 2, 3), out(w, 7, 2, 3))
    stem = flops(size, _planes(model)[0], 3, 7)
    total = stem
    size = tuple(out(n, 3, 2, 1) for n in size)  # the max-pool
    cin, levels = _planes(model)[0], []
    for i, (p, n) in enumerate(zip(_planes(model), BLOCKS)):
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            total += flops(size, p, cin, 1)
            size = tuple(out(m, 3, stride, 1) for m in size)
            total += flops(size, p, p, 3) + flops(size, 4 * p, p, 1)
            if j == 0:
                total += flops(size, 4 * p, cin, 1)
            cin = 4 * p
        if i > 0:
            levels.append(size)
    c = model["out_channel"]
    for size, cin in zip(levels, model["in_channels"]):
        total += flops(size, c, cin, 1)  # lateral
    total += flops(levels[0], c, c, 3) + flops(levels[1], c, c, 3)  # merges
    heads = _anchors(model) * sum(WIDTHS.values())
    for size in levels:
        total += flops(size, c // 2, c, 3) + flops(size, c // 4, c, 3) \
            + 3 * flops(size, c // 4, c // 4, 3) + flops(size, heads, c, 1)
    return total, stem


def score_heads(model: dict) -> list[tuple[str, slice, int]]:
    """Each level's class-head bias, once an anchor: the anchor's
    candidates (its rows interleave with the other anchor's: a step of
    the anchors a location) and the bias entry of its face logit, ``2 a +
    1`` (a softmax of two shifts its score's logit by that entry)."""
    out, start, k = [], 0, _anchors(model)
    for lvl, (rows, cols) in enumerate(feature_maps(model)):
        n = rows * cols * k
        out += [(f"ClassHead.{lvl}.conv1x1.bias", slice(start + a, start + n, k), 2 * a + 1)
                for a in range(k)]
        start += n
    return out


def decode_tables(model: dict, n_rows: int, device) -> tuple:
    """The rows are normalised: pixels are ``x * W``, ``y * H``."""
    h, w = model["input_shape"]
    ones, zeros = torch.ones(n_rows, device=device), torch.zeros(n_rows, device=device)
    return ones * w, zeros, ones * h, zeros, float(w), float(h)


def candidates(rows: torch.Tensor, model: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's ``(N, 15)`` rows -> scores and boxes, by the shared
    linear decode of the first five columns."""
    return linear_candidates(rows[:, :5], decode_tables(model, rows.shape[0], rows.device))


def landmarks_px(rows: torch.Tensor, model: dict) -> torch.Tensor:
    """``(N, 15)`` rows -> ``(N, 10)`` points in pixels, ``x * W``, ``y *
    H`` (not rounded)."""
    h, w = model["input_shape"]
    xy = rows[:, 5:].unflatten(-1, (5, 2))
    return torch.stack([xy[..., 0] * float(w), xy[..., 1] * float(h)], -1).flatten(-2)


def targets(model: dict, train: dict, boxes, valid, size, device):
    raise NotImplementedError(TRAINING)


def loss(pred, target, real, train: dict):
    raise NotImplementedError(TRAINING)


def box_rows(model: dict):
    raise NotImplementedError(TRAINING)
