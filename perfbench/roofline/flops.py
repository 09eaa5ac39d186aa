"""Analytic model FLOPs (2 a multiply-add) of the convolutions and linear
layers of one image's forward, counted from the configuration's shapes,
whatever implements them.

A training step's FLOPs an image (:func:`train_step_flops`): the forward,
the weight gradient of every layer and the input gradient of every layer
but the first (whose input is the image), at each of SAM's two points:
``2 (3 F - F_first)``.

PoolResnet's arithmetic is ``fdtpu_torch/bench.py``'s
``poolresnet_forward_flops`` (itself a copy of the JAX package's
``bench.py``), generalised to the stem and head geometry of the
configuration; the SSD's is new. A family's reference module names its
counter (``flop_counts``), which :func:`forward_flops` and
:func:`train_step_flops` reach by the configuration's ``reference`` key.
"""

from __future__ import annotations

from perfbench.reference import family


def _conv(out_hw: int, cout: int, cin: int, k: int) -> float:
    return 2.0 * out_hw * out_hw * cout * cin * k * k


def poolresnet(model: dict) -> tuple[float, float]:
    """-> ``(forward FLOPs, the stem's)`` of one image."""
    f, k, s = model["filters"], model["input_kernel_size"], model["input_stride"]
    pad = k - s
    dim = (model["input_shape"][0] + 2 * pad - k) // s + 1
    stem = _conv(dim, f, 3, k)
    total = stem
    for _ in range(model["num_residual_blocks"]):
        total += 2 * _conv(dim, f, f, 3)
        if dim > 2 * model["num_patches"]:
            dim //= 2
    ok = model["output_kernel_size"]
    out = dim + 2 * model["output_padding"] - ok + 1
    return total + _conv(out, 5, f, ok), stem


def ssd(model: dict) -> tuple[float, float]:
    """-> ``(forward FLOPs, the stem's)`` of one image: the stride-2 stem,
    each block's 1x1 projection (where the channels change) and two 3x3
    convolutions at the block's input size (a pooling block pools last),
    and the heads' ``Linear(ch -> 5)`` at every cell of their scale."""
    f, top = model["filters"], 16 * model["filters"]
    dim = (model["input_shape"][0] + 2 - 3) // 2 + 1
    stem = _conv(dim, f, 3, 3)
    total = stem
    blocks = [(f, 2 * f, True), (2 * f, 2 * f, True)] + [(2 * f, 2 * f, False)] * 6 \
        + [(2 * f, 4 * f, False)]
    scales = []
    for i in range(len(model["patch_sizes"])):
        cin = min(4 * f * 2**i, top)
        scales.append((cin, min(2 * cin, top), i != 0))
    for i, (cin, cout, pools) in enumerate(blocks + scales):
        if cin != cout:
            total += _conv(dim, cout, cin, 1)
        total += _conv(dim, cout, cin, 3) + _conv(dim, cout, cout, 3)
        if pools:
            dim //= 2
        if i >= len(blocks):
            total += 2.0 * dim * dim * cout * 5
    return total, stem


def forward_flops(reference: str, model: dict) -> float:
    """The forward's FLOPs of one image, by the family's reference module
    (its ``flop_counts``)."""
    return family(reference).flop_counts(model)[0]


def train_step_flops(reference: str, model: dict) -> float:
    """A SAM training step's FLOPs an image."""
    fwd, first = family(reference).flop_counts(model)
    return 2.0 * (3.0 * fwd - first)
