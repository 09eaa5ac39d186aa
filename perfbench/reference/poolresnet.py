"""PoolResnet, the YOLO-v1-style grid detector of the reference repository
(``models/PoolResnet.py``), in plain float32 PyTorch.

A stem convolution (``input_kernel_size`` / ``input_stride``, padded by
their difference), ``num_residual_blocks`` blocks of ``conv3x3 -> leaky ->
conv3x3 -> leaky -> dropout(0.25) -> + skip -> 2x2 max-pool while the
height exceeds twice the grid``, then head dropout (0.5), a valid head
convolution to 5 channels and a sigmoid: ``(B, S, S, 5)`` rows ``[conf,
x_rel, y_rel, w_norm, h_norm]``. Weights: LeCun-normal kernels (truncated
at two standard deviations), zero biases, as Flax's defaults that the
program starts from.
"""

from __future__ import annotations

import torch

from perfbench.reference import objectives
from perfbench.reference.nn import FLOAT32, NO_DROPOUT, Masks, Precision, conv, leaky, max_pool
from perfbench.reference.serve import linear_candidates
from perfbench.roofline import flops

flop_counts = flops.poolresnet  # the forward's FLOPs of one image, and the stem's
ROW = 5  # [conf, x_rel, y_rel, w_norm, h_norm]
TINY = dict(filters=8, input_shape=[64, 64], num_patches=2, num_residual_blocks=2,
            output_kernel_size=3)  # the CPU dry runs' sizes


def _blocks(model: dict) -> int:
    return model["num_residual_blocks"]


def param_specs(model: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, (initialiser, fan_in))`` of every parameter, named as
    the program's ``state_dict``."""
    f, k, ok = model["filters"], model["input_kernel_size"], model["output_kernel_size"]

    def layer(name, cout, cin, kk):
        fan_in = cin * kk * kk
        return [(f"{name}.weight", (cout, cin, kk, kk), ("lecun_normal", fan_in)),
                (f"{name}.bias", (cout,), ("zeros", fan_in))]

    specs = layer("conv1", f, 3, k)
    for i in range(_blocks(model)):
        specs += layer(f"residual_blocks.{i}.conv1", f, f, 3)
        specs += layer(f"residual_blocks.{i}.conv2", f, f, 3)
    return specs + layer("out", 5, f, ok)


def score_heads(model: dict) -> list[tuple[str, slice, int]]:
    """The bias that sets the candidates' scores, which candidates it
    sets, and its entry that shifts their score logits."""
    return [("out.bias", slice(None), 0)]


def box_rows(model: dict) -> list[tuple[str, slice]]:
    """The leaves whose rows (along dim 0) write the box coordinates, and
    those rows: the head's ``[x_rel, y_rel, w_norm, h_norm]``."""
    return [("out.weight", slice(1, 5)), ("out.bias", slice(1, 5))]


def grid_size(model: dict) -> int:
    pad = model["input_kernel_size"] - model["input_stride"]
    dim = (model["input_shape"][0] + 2 * pad - model["input_kernel_size"]) \
        // model["input_stride"] + 1
    for _ in range(_blocks(model)):
        if dim > 2 * model["num_patches"]:
            dim //= 2
    return dim + 2 * model["output_padding"] - model["output_kernel_size"] + 1


def forward(params: dict, images: torch.Tensor, model: dict, prec: Precision = FLOAT32,
            masks: Masks = NO_DROPOUT) -> torch.Tensor:
    """``images`` ``(B, H, W, 3)`` float32 in [0, 1] -> ``(B, S, S, 5)``."""
    p = params
    x = images.permute(0, 3, 1, 2)
    x = conv(x, p["conv1.weight"], p["conv1.bias"], prec, model["input_stride"],
             model["input_kernel_size"] - model["input_stride"])
    pool_until = 2 * model["num_patches"]
    for i in range(_blocks(model)):
        n = f"residual_blocks.{i}"
        skip = x
        y = prec.round(leaky(conv(x, p[f"{n}.conv1.weight"], p[f"{n}.conv1.bias"], prec, 1, 1)))
        y = prec.round(leaky(conv(y, p[f"{n}.conv2.weight"], p[f"{n}.conv2.bias"], prec, 1, 1)))
        x = prec.round(prec.round(masks.apply(y, model["dropout"])) + skip)
        if x.shape[2] > pool_until:
            x = max_pool(x)
    x = prec.round(masks.apply(x, model["head_dropout"]))
    x = conv(x, p["out.weight"], p["out.bias"], prec, 1, model["output_padding"])
    return torch.sigmoid(x).permute(0, 2, 3, 1)


def decode_tables(model: dict, n_rows: int, device) -> tuple:
    """Per candidate ``(scale_x, offset_x, scale_y, offset_y)`` and the
    width and height scales of a row-major ``(S, S, 5)`` map:
    ``x = x_rel * W / S + x_cell * W / S``, ``w = w_norm * W``."""
    h, w = model["input_shape"]
    s = grid_size(model)
    cells = torch.arange(s * s, device=device)
    xp, yp = w / s, h / s
    col, row = (cells % s).float(), torch.div(cells, s, rounding_mode="floor").float()
    return (torch.full((s * s,), xp, device=device), col * xp,
            torch.full((s * s,), yp, device=device), row * yp, float(w), float(h))


def candidates(rows: torch.Tensor, model: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's ``(S * S, 5)`` rows -> scores and boxes, by the shared
    linear decode."""
    return linear_candidates(rows, decode_tables(model, rows.shape[0], rows.device))


def targets(model: dict, train: dict, boxes, valid, size: tuple[int, int], device):
    """A batch's pixel boxes -> the grid's ``(B, S, S, 5)`` targets."""
    return objectives.grid_targets(boxes, valid, grid_size(model), size)


def loss(pred, target, real, train: dict):
    """-> ``(the YOLO loss's mean over the batch's real images, which is
    differentiated, its batch sum, which is reported)``."""
    total = (objectives.yolo_loss(pred, target) * real).sum()
    return total / real.sum().clamp_min(1), total
