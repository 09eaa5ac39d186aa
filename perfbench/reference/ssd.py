"""The SSD of the reference repository (``models/SSD.py``), in plain
float32 PyTorch.

A stride-2 3x3 stem, a 9-block extractor (``f -> 2f`` and ``2f -> 2f``
blocks that pool, six ``2f`` blocks, one ``2f -> 4f``), then one block a
scale, each with a position-wise ``Linear(ch -> 5)`` head. A block is
``conv3x3 -> leaky -> conv3x3 -> leaky -> dropout(0.25) -> + skip`` (a 1x1
projection where the channels change) and a closing 2x2 max-pool where it
pools. Scale ``i`` reads ``min(4f 2^i, 16f)`` channels and writes ``min(2
in, 16f)``; every scale but the first pools. The heads' rows, NHWC
row-major, are concatenated; the sigmoid goes on the scores and the priors
are applied: ``x = x_enc / ps + x_cell / ps`` (the priors have no extent).
Weights: torch's default init, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
kernels and biases.
"""

from __future__ import annotations

import torch

from perfbench.reference import objectives
from perfbench.reference.nn import (
    FLOAT32,
    NO_DROPOUT,
    Masks,
    Precision,
    conv,
    leaky,
    linear,
    max_pool,
)
from perfbench.reference.serve import linear_candidates
from perfbench.roofline import flops

flop_counts = flops.ssd  # the forward's FLOPs of one image, and the stem's
ROW = 5  # [score, x, y, w, h], normalised
TINY = dict(filters=4, input_shape=[64, 64], patch_sizes=[8, 4, 2, 1])  # the CPU dry runs'


def blocks(model: dict) -> list[tuple[str, int, int, bool]]:
    """``(name, in, out, pools)`` of every block in forward order."""
    f, top = model["filters"], 16 * model["filters"]
    out = [("extractor.0", f, 2 * f, True), ("extractor.1", 2 * f, 2 * f, True)]
    out += [(f"extractor.{i}", 2 * f, 2 * f, False) for i in range(2, 8)]
    out.append(("extractor.8", 2 * f, 4 * f, False))
    for i in range(len(model["patch_sizes"])):
        cin = min(4 * f * 2**i, top)
        out.append((f"scales.{i}", cin, min(2 * cin, top), i != 0))
    return out


def param_specs(model: dict) -> list[tuple[str, tuple, tuple]]:
    def layer(name, cout, cin, k):
        fan_in = cin * k * k
        return [(f"{name}.weight", (cout, cin, k, k), ("torch_uniform", fan_in)),
                (f"{name}.bias", (cout,), ("torch_uniform", fan_in))]

    specs = layer("stem", model["filters"], 3, 3)
    heads = []
    for name, cin, cout, _ in blocks(model):
        if cin != cout:
            specs += layer(f"{name}.skip", cout, cin, 1)
        specs += layer(f"{name}.conv1", cout, cin, 3)
        specs += layer(f"{name}.conv2", cout, cout, 3)
        if name.startswith("scales."):
            i = name.split(".")[1]
            heads += [(f"heads.{i}.weight", (5, cout), ("torch_uniform", cout)),
                      (f"heads.{i}.bias", (5,), ("torch_uniform", cout))]
    return specs + heads


def score_heads(model: dict) -> list[tuple[str, slice, int]]:
    """Each head's bias, the candidates of its scale, and the bias's entry
    that shifts their score logits."""
    out, start = [], 0
    for i, ps in enumerate(model["patch_sizes"]):
        out.append((f"heads.{i}.bias", slice(start, start + ps * ps), 0))
        start += ps * ps
    return out


def box_rows(model: dict) -> list[tuple[str, slice]]:
    """The leaves whose rows (along dim 0) write the box coordinates, and
    those rows: each head's ``[x, y, w, h]``, which the loss reads at the
    positives alone (mining does not select them)."""
    return [(f"heads.{i}.{part}", slice(1, 5))
            for i in range(len(model["patch_sizes"])) for part in ("weight", "bias")]


def priors(patch_sizes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 2)`` prior corners ``[x_cell / ps, y_cell / ps]`` and ``(N,)``
    cell sizes ``1 / ps``, each scale row-major over ``(y_cell, x_cell)``."""
    xy, scale = [], []
    for ps in patch_sizes:
        cells = torch.arange(ps, dtype=torch.float32, device=device) / ps
        xy.append(torch.stack([cells.expand(ps, ps), cells[:, None].expand(ps, ps)], -1)
                  .reshape(ps * ps, 2))
        scale.append(torch.full((ps * ps,), 1.0 / ps, device=device))
    return torch.cat(xy), torch.cat(scale)


def forward(params: dict, images: torch.Tensor, model: dict, prec: Precision = FLOAT32,
            masks: Masks = NO_DROPOUT) -> torch.Tensor:
    """``images`` ``(B, H, W, 3)`` float32 in [0, 1] -> ``(B, N, 5)``
    normalised rows ``[score, x, y, w, h]`` with the priors applied."""
    p = params
    x = conv(images.permute(0, 3, 1, 2), p["stem.weight"], p["stem.bias"], prec, 2, 1)
    outs = []
    scale_i = 0
    for name, cin, cout, pools in blocks(model):
        def layer(x, part, k_pad):
            return conv(x, p[f"{name}.{part}.weight"], p[f"{name}.{part}.bias"], prec, 1, k_pad)

        skip = x if cin == cout else layer(x, "skip", 0)
        y = prec.round(leaky(layer(x, "conv1", 1)))
        y = prec.round(leaky(layer(y, "conv2", 1)))
        x = prec.round(prec.round(masks.apply(y, model["dropout"])) + skip)
        if pools:
            x = max_pool(x)
        if name.startswith("scales."):
            ps = model["patch_sizes"][scale_i]
            if x.shape[2:] != (ps, ps):
                raise ValueError(f"scale {scale_i}: {tuple(x.shape[2:])} != {ps}")
            z = linear(x.permute(0, 2, 3, 1), p[f"heads.{scale_i}.weight"],
                       p[f"heads.{scale_i}.bias"], prec)
            outs.append(z.reshape(x.shape[0], ps * ps, 5))
            scale_i += 1
    out = torch.cat(outs, dim=1)
    corner, size = priors(model["patch_sizes"], out.device)
    xy = out[..., 1:3] * size[:, None] + corner
    return torch.cat([torch.sigmoid(out[..., :1]), xy, out[..., 3:5]], dim=-1)


def decode_tables(model: dict, n_rows: int, device) -> tuple:
    """The model's rows are normalised: pixels are ``x * W``, ``y * H``."""
    h, w = model["input_shape"]
    ones = torch.ones(n_rows, device=device)
    zeros = torch.zeros(n_rows, device=device)
    return ones * w, zeros, ones * h, zeros, float(w), float(h)


def candidates(rows: torch.Tensor, model: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's ``(N, 5)`` rows -> scores and boxes, by the shared
    linear decode."""
    return linear_candidates(rows, decode_tables(model, rows.shape[0], rows.device))


def targets(model: dict, train: dict, boxes, valid, size: tuple[int, int], device):
    """A batch's pixel boxes -> ``(the (B, N, 5) prior targets, their
    (B, N, 4) locations with the priors applied)``."""
    enc = objectives.ssd_targets(boxes, valid, model["patch_sizes"], size)
    corner, scale = priors(model["patch_sizes"], device)
    gt_locs = torch.cat([enc[..., 1:3] * scale[:, None] + corner, enc[..., 3:5]], -1)
    return enc, gt_locs


def loss(pred, target, real, train: dict):
    """The SSD loss with the batch's left-out images' labels zeroed; it is
    both differentiated and reported."""
    enc, gt_locs = target
    e = enc * real[:, None, None]
    out = objectives.ssd_loss(pred[..., 0], pred[..., 1:5], e[..., 0], gt_locs,
                              train["neg_pos_ratio"], train.get("bg_push", 0.0))
    return out, out
