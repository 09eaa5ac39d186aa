"""Train state and optimizer construction (``fdtpu/train/state.py``).

fdtpu's state is an immutable pytree: params, optimizer state and a step
counter. Here it is a mutable object that holds the float32 module, its
``torch.optim`` optimizer, the MultiStep learning-rate schedule and the
``torch.Generator`` that the step's augmentation and dropout draw from; a
train step updates it in place.

A state whose step is replayed from a CUDA graph (``train/graphs.py``) has
its optimizer built ``capturable``: Adam's learning rate is then a 0-d
float32 tensor on the card that :func:`set_learning_rate` fills before each
step, and its ``step`` counts on the card. The Trainer asks for it where it
replays (on a card, without ``nan_check``, over no group or an NCCL one:
``Trainer.replays``); every other state keeps ``torch.optim``'s defaults,
whose eager update launches fewer kernels. SGD keeps a float rate
either way, which its update passes to the card as a host scalar: a
captured SGD step is captured again when the rate changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from fdtpu_torch.utils.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    step: int
    module: torch.nn.Module  # float32 params; computes in module.compute_dtype
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator  # on the module's device


def make_lr_schedule(config: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR as a function of the step: the learning rate times
    ``lr_gamma`` for every milestone epoch reached (``step >= milestone *
    steps_per_epoch``). Values are float32, as optax's
    ``piecewise_constant_schedule`` gives them."""
    boundaries = sorted(
        (int(m) * steps_per_epoch, np.float32(config.lr_gamma)) for m in config.lr_milestones
    )

    def schedule(step: int) -> float:
        v = np.float32(config.learning_rate)
        for boundary, scale in boundaries:
            if step >= boundary:
                v = np.float32(scale * v)
        return float(v)

    return schedule


def make_optimizer(config: TrainConfig, params, capturable: bool = False
                   ) -> torch.optim.Optimizer:
    """Adam with the reference's defaults (betas 0.9/0.999, eps 1e-8), or
    plain SGD with ``config.optimizer="sgd"`` (where Adam's sign-like first
    steps would amplify rounding noise, as in cross-framework tests). The
    train step sets each step's learning rate from the schedule
    (:func:`set_learning_rate`). ``capturable`` builds Adam for a CUDA
    graph, with its rate a 0-d float32 tensor on the params' device; the
    eager and the captured step then run the same optimizer."""
    params = list(params)
    lr = float(np.float32(config.learning_rate))
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if config.optimizer != "adam":
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    if capturable:
        lr_tensor = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        return torch.optim.Adam(params, lr=lr_tensor, betas=(0.9, 0.999), eps=1e-8,
                                capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every param group's rate to ``lr``: in place where the rate is a
    tensor (a capturable Adam's, which a captured step reads), as a float
    otherwise."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def is_capturable(optimizer: torch.optim.Optimizer) -> bool:
    return all(group.get("capturable", False) for group in optimizer.param_groups)


def adam_step_count(optimizer: torch.optim.Optimizer, param: torch.Tensor,
                    count) -> torch.Tensor:
    """Adam's ``step`` for ``param`` where ``torch.optim`` keeps it: a
    float32 0-d tensor, on the param's device when the optimizer is
    capturable, on the host otherwise."""
    device = param.device if is_capturable(optimizer) else "cpu"
    if isinstance(count, torch.Tensor):
        return count.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(float(count), dtype=torch.float32, device=device)


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Make Adam's state of every param that has none, as its first step
    would (``step`` 0, zero moments), so that its tensors exist before a
    capture; SGD keeps none."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state[p]:
                optimizer.state[p] = {
                    "step": adam_step_count(optimizer, p, 0.0),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }


def create_train_state(module: torch.nn.Module, config: TrainConfig,
                       steps_per_epoch: int = 1000, capturable: bool = False) -> TrainState:
    """A state at step 0 around ``module``, whose float32 params (already
    initialized or loaded) train in place; the module is put in
    channels_last memory format. ``capturable``: the optimizer of a step
    replayed from a CUDA graph (:func:`make_optimizer`)."""
    module = module.to(memory_format=torch.channels_last)
    device = next(module.parameters()).device
    return TrainState(
        step=0,
        module=module,
        optimizer=make_optimizer(config, list(module.parameters()), capturable),
        schedule=make_lr_schedule(config, steps_per_epoch),
        generator=torch.Generator(device=device).manual_seed(config.seed),
    )
