"""Train state and optimizer construction (``fdtpu/train/state.py``).

fdtpu's state is an immutable pytree: params, optimizer state and a step
counter. Here it is a mutable object that holds the float32 module, its
``torch.optim`` optimizer, the MultiStep learning-rate schedule and the
``torch.Generator`` that the step's augmentation and dropout draw from; a
train step updates it in place.
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


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam with the reference's defaults (betas 0.9/0.999, eps 1e-8), or
    plain SGD with ``config.optimizer="sgd"`` (where Adam's sign-like first
    steps would amplify rounding noise, as in cross-framework tests). The
    train step sets each step's learning rate from the schedule."""
    lr = float(np.float32(config.learning_rate))
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if config.optimizer != "adam":
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(module: torch.nn.Module, config: TrainConfig,
                       steps_per_epoch: int = 1000) -> TrainState:
    """A state at step 0 around ``module``, whose float32 params (already
    initialized or loaded) train in place; the module is put in
    channels_last memory format."""
    module = module.to(memory_format=torch.channels_last)
    device = next(module.parameters()).device
    return TrainState(
        step=0,
        module=module,
        optimizer=make_optimizer(config, list(module.parameters())),
        schedule=make_lr_schedule(config, steps_per_epoch),
        generator=torch.Generator(device=device).manual_seed(config.seed),
    )
