"""Carry fdtpu's Flax params, and its train state, across to the port.

fdtpu keeps conv kernels in HWIO; torch keeps them in OIHW. The names follow
the reference torch model, the same mapping ``fdtpu/compat/torch_import.py``
applies in the other direction. Nothing here imports JAX: the leaves are
read with ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.models.ssd import SSD

EXTRACTOR_BLOCKS = 9  # fdtpu's SSD: SSDResidualBlock_0..8 extract, the rest are scales


def _conv(tree, prefix: str) -> dict[str, torch.Tensor]:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        f"{prefix}.bias": torch.from_numpy(np.array(tree["bias"], dtype=np.float32)),
    }


def poolresnet_state_dict(params) -> dict[str, torch.Tensor]:
    """fdtpu ``PoolResnet`` params (the ``variables["params"]`` tree, numpy
    leaves) -> the port's ``PoolResnet`` ``state_dict``.

    ``Conv_0`` -> ``conv1``; ``ResidualBlock_{i}/Conv_{0,1}`` ->
    ``residual_blocks.{i}.conv{1,2}``; ``Conv_1`` (the head) -> ``out``.
    Params of a ``fast_stem=True`` model have the same tree and load too.
    """
    blocks = sorted(
        (k for k in params if k.startswith("ResidualBlock_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    unknown = set(params) - {"Conv_0", "Conv_1", *blocks}
    if unknown:
        raise ValueError(f"not a PoolResnet param tree: unexpected {sorted(unknown)}")
    sd = _conv(params["Conv_0"], "conv1")
    for i, name in enumerate(blocks):
        if name != f"ResidualBlock_{i}":
            raise ValueError(f"residual blocks are not numbered 0..{len(blocks) - 1}")
        sd.update(_conv(params[name]["Conv_0"], f"residual_blocks.{i}.conv1"))
        sd.update(_conv(params[name]["Conv_1"], f"residual_blocks.{i}.conv2"))
    sd.update(_conv(params["Conv_1"], "out"))
    return sd


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


def state_dict_from_fdtpu(params, module) -> dict[str, torch.Tensor]:
    """fdtpu params (or an optimizer's tree of the same shape) as
    ``module``'s ``state_dict``: :func:`ssd_state_dict` for an ``SSD``,
    :func:`poolresnet_state_dict` otherwise."""
    if isinstance(module, SSD):
        return ssd_state_dict(params)
    return poolresnet_state_dict(params)


def train_state_from_fdtpu(state, module, config, steps_per_epoch: int = 1000):
    """An fdtpu ``TrainState`` (PoolResnet or SSD params, optax Adam or SGD)
    as the port's train state around ``module``: the step, the params
    through :func:`state_dict_from_fdtpu`, and optax Adam's ``count``,
    ``mu`` and ``nu`` as ``torch.optim.Adam``'s ``step``, ``exp_avg`` and
    ``exp_avg_sq``. A step from the result can then be held against a step
    of fdtpu's state."""
    from fdtpu_torch.train.state import create_train_state

    module.load_state_dict(state_dict_from_fdtpu(state.params, module))
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
