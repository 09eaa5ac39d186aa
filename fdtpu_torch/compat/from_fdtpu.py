"""Carry fdtpu's Flax params, and its train state, across to the port.

fdtpu keeps conv kernels in HWIO (a depthwise kernel as ``(k, k, 1, C)``);
torch keeps them in OIHW. The names follow the reference torch model for
the grid families and the SSD, the same mapping
``fdtpu/compat/torch_import.py`` applies in the other direction, and
fdtpu's own for MobileNetV3, whose BatchNorm ``scale``/``bias`` become
``weight``/``bias`` and whose ``batch_stats`` ``mean``/``var`` become the
``running_mean``/``running_var`` buffers. Nothing here imports JAX: the
leaves are read with ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.resnet import Resnet
from fdtpu_torch.models.separable import SeparableCNN
from fdtpu_torch.models.ssd import SSD

EXTRACTOR_BLOCKS = 9  # fdtpu's SSD: SSDResidualBlock_0..8 extract, the rest are scales


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def _conv(tree, prefix: str) -> dict[str, torch.Tensor]:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    sd = {f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))}
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _tensor(tree["bias"])
    return sd


def _grid_state_dict(params, block: str, convs: tuple[str, ...], family: str):
    """The grid families' shared tree: ``Conv_0`` -> ``conv1``;
    ``{block}_{i}/Conv_{j}`` -> ``residual_blocks.{i}.{convs[j]}``;
    ``Conv_1`` (the head) -> ``out``. Any other tree raises."""
    blocks = _numbered(params, f"{block}_")
    unknown = set(params) - {"Conv_0", "Conv_1", *blocks}
    if unknown or not {"Conv_0", "Conv_1"} <= set(params):
        raise ValueError(f"not a {family} param tree: {sorted(params)}")
    sd = _conv(params["Conv_0"], "conv1")
    for i, name in enumerate(blocks):
        if set(params[name]) != {f"Conv_{j}" for j in range(len(convs))}:
            raise ValueError(f"not a {family} block: {name} holds {sorted(params[name])}")
        for j, conv in enumerate(convs):
            sd.update(_conv(params[name][f"Conv_{j}"], f"residual_blocks.{i}.{conv}"))
    sd.update(_conv(params["Conv_1"], "out"))
    return sd


def poolresnet_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``PoolResnet`` params (the ``variables["params"]`` tree, numpy
    leaves) -> the port's ``PoolResnet`` ``state_dict``.

    ``Conv_0`` -> ``conv1``; ``ResidualBlock_{i}/Conv_{0,1}`` ->
    ``residual_blocks.{i}.conv{1,2}``; ``Conv_1`` (the head) -> ``out``.
    Params of a ``fast_stem=True`` model have the same tree and load too.
    """
    return _grid_state_dict(params, "ResidualBlock", ("conv1", "conv2"), "PoolResnet")


def resnet_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``Resnet`` params -> the port's ``Resnet`` ``state_dict``:
    PoolResnet's tree and names."""
    return _grid_state_dict(params, "ResidualBlock", ("conv1", "conv2"), "Resnet")


def separable_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``SeparableCNN`` params -> the port's ``SeparableCNN``
    ``state_dict``: ``Conv_0`` -> ``conv1``;
    ``SeparableResidualBlock_{i}/Conv_{0,1,2}`` ->
    ``residual_blocks.{i}.pointwise_conv1/.depthwise_conv/.pointwise_conv2``
    (no biases); ``Conv_1`` -> ``out``. A ``fast_stem`` model's params have
    the same tree."""
    return _grid_state_dict(params, "SeparableResidualBlock",
                            ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"),
                            "SeparableCNN")


def _bn(params, stats, prefix: str) -> dict[str, torch.Tensor]:
    sd = {f"{prefix}.weight": _tensor(params["scale"]), f"{prefix}.bias": _tensor(params["bias"])}
    if stats is not None:
        sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
        sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    return sd


MNV3_BLOCK_CONVS = ("conv_pw", "conv_dw", "conv_pwl")
MNV3_BLOCK_BNS = ("bn1", "bn2", "bn3")


def mobilenetv3_state_dict(params, batch_stats=None) -> dict[str, torch.Tensor]:
    """fdtpu ``MobileNetV3Backbone`` params (and its ``batch_stats``, both
    with numpy leaves) -> the port's ``MobileNetV3Backbone`` ``state_dict``,
    under fdtpu's names: ``conv_stem``, ``bn1``,
    ``block{i}.{conv_pw,bn1,conv_dw,bn2,se.reduce,se.expand,conv_pwl,bn3}``
    -> ``blocks.{i}.*``, ``conv_576``, ``bn_576``, ``head``. BatchNorm
    ``scale``/``bias`` -> ``weight``/``bias``; ``batch_stats``
    ``mean``/``var`` -> ``running_mean``/``running_var``. Without
    ``batch_stats`` (an optimizer's tree of the params' shape) only the
    params come across."""
    stats = (lambda *path: _get(batch_stats, path)) if batch_stats is not None else \
        (lambda *path: None)
    blocks = _numbered(params, "block")
    unknown = set(params) - {"conv_stem", "bn1", "conv_576", "bn_576", "head", *blocks}
    if unknown or "conv_stem" not in params:
        raise ValueError(f"not a MobileNetV3 param tree: {sorted(params)}")
    sd = {**_conv(params["conv_stem"], "conv_stem"), **_bn(params["bn1"], stats("bn1"), "bn1")}
    for i, name in enumerate(blocks):
        block = params[name]
        for conv in MNV3_BLOCK_CONVS:
            if conv in block:
                sd.update(_conv(block[conv], f"blocks.{i}.{conv}"))
        for bn in MNV3_BLOCK_BNS:
            if bn in block:
                sd.update(_bn(block[bn], stats(name, bn), f"blocks.{i}.{bn}"))
        if "se" in block:
            for conv in ("reduce", "expand"):
                sd.update(_conv(block["se"][conv], f"blocks.{i}.se.{conv}"))
    sd.update(_conv(params["conv_576"], "conv_576"))
    sd.update(_bn(params["bn_576"], stats("bn_576"), "bn_576"))
    sd.update(_conv(params["head"], "head"))
    return sd


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _numbered(params, prefix: str) -> list[str]:
    """The keys ``{prefix}0, {prefix}1, ...`` of ``params``, in order;
    raises unless they run from 0 without a gap."""
    keys = sorted((k for k in params if k.startswith(prefix)), key=lambda k: int(k[len(prefix):]))
    if keys != [f"{prefix}{i}" for i in range(len(keys))]:
        raise ValueError(f"{prefix}* are not numbered 0..{len(keys) - 1}: {keys}")
    return keys


def ssd_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``SSD`` params (the ``variables["params"]`` tree, numpy leaves)
    -> the port's ``SSD`` ``state_dict``.

    ``Conv_0`` -> ``stem``; ``SSDResidualBlock_{i}`` -> ``extractor.{i}``
    for i < 9, ``scales.{i - 9}`` after; ``Dense_{k}`` -> ``heads.{k}`` (its
    ``(in, 5)`` kernel transposed). Flax names a block's convs in call
    order: with a 1x1 skip projection (``in != out``) ``Conv_0`` is the
    skip and ``Conv_1``/``Conv_2`` the 3x3 convs, else ``Conv_0``/``Conv_1``
    are. A ``fast_blocks`` model has the same tree. Any other tree raises.
    """
    blocks = _numbered(params, "SSDResidualBlock_")
    heads = _numbered(params, "Dense_")
    unknown = set(params) - {"Conv_0", *blocks, *heads}
    if unknown or "Conv_0" not in params or len(blocks) != EXTRACTOR_BLOCKS + len(heads) \
            or not heads:
        raise ValueError(f"not an SSD param tree: {sorted(params)}")
    sd = _conv(params["Conv_0"], "stem")
    for i, name in enumerate(blocks):
        prefix = f"extractor.{i}" if i < EXTRACTOR_BLOCKS else f"scales.{i - EXTRACTOR_BLOCKS}"
        block = params[name]
        if set(block) == {"Conv_0", "Conv_1", "Conv_2"}:
            names = {"Conv_0": "skip", "Conv_1": "conv1", "Conv_2": "conv2"}
        elif set(block) == {"Conv_0", "Conv_1"}:
            names = {"Conv_0": "conv1", "Conv_1": "conv2"}
        else:
            raise ValueError(f"not an SSD block: {name} holds {sorted(block)}")
        for flax_name, torch_name in names.items():
            sd.update(_conv(block[flax_name], f"{prefix}.{torch_name}"))
    for k, name in enumerate(heads):
        kernel = np.asarray(params[name]["kernel"], dtype=np.float32)  # (in, 5)
        sd[f"heads.{k}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        sd[f"heads.{k}.bias"] = torch.from_numpy(np.array(params[name]["bias"], dtype=np.float32))
    return sd


def state_dict_from_fdtpu(params, module, batch_stats=None) -> dict[str, torch.Tensor]:
    """fdtpu params (or an optimizer's tree of the same shape), and a
    MobileNetV3's ``batch_stats``, as ``module``'s ``state_dict``: the
    converter of ``module``'s class. Any other class raises."""
    if type(module) is MobileNetV3Backbone:
        return mobilenetv3_state_dict(params, batch_stats)
    converters = {PoolResnet: poolresnet_state_dict, Resnet: resnet_state_dict,
                  SeparableCNN: separable_state_dict, SSD: ssd_state_dict}
    if type(module) not in converters:
        raise ValueError(f"no converter from fdtpu params for {type(module).__name__}")
    return converters[type(module)](params)


def train_state_from_fdtpu(state, module, config, steps_per_epoch: int = 1000):
    """An fdtpu ``TrainState`` (params of any family of the zoo, with its
    ``batch_stats``; optax Adam or SGD) as the port's train state around
    ``module``: the step, the params and BatchNorm statistics through
    :func:`state_dict_from_fdtpu`, and optax Adam's ``count``, ``mu`` and
    ``nu`` as ``torch.optim.Adam``'s ``step``, ``exp_avg`` and
    ``exp_avg_sq``. A step from the result can then be held against a step
    of fdtpu's state."""
    from fdtpu_torch.train.state import create_train_state

    module.load_state_dict(state_dict_from_fdtpu(state.params, module,
                                                 state.batch_stats or None))
    ts = create_train_state(module, config, steps_per_epoch)
    ts.step = int(np.asarray(state.step))
    if config.optimizer == "sgd":
        return ts
    adam = [s for s in _walk(state.opt_state) if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError("expected one optax Adam state in the fdtpu opt_state")
    mu, nu = (state_dict_from_fdtpu(t, module) for t in (adam[0].mu, adam[0].nu))
    count = float(np.asarray(adam[0].count))
    for name, p in module.named_parameters():
        ts.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name]),
        }
    return ts


def _walk(opt_state):
    """The states inside an optax chain's nested tuples."""
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        for s in opt_state:
            yield from _walk(s)
    else:
        yield opt_state
