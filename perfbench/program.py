"""The system under test, ``fdtpu_torch``, built from a configuration file
as its entry points build it: ``train_model`` / ``train_model_ssd`` for a
Trainer, ``load_checkpoint`` for a serving Detector. The weights are the
benchmark's, loaded into the module the program builds. What differs by
family is in ``programs/<family>.py``, named by the configuration's
``family`` key."""

from __future__ import annotations

import torch

from perfbench import families


def family(config: dict):
    """The program module of a configuration's ``family``."""
    return families.load("programs", config["family"])


def module(config: dict, weights: dict, device: torch.device, train: bool) -> torch.nn.Module:
    """The program's float32 module holding ``weights``; one to train
    computes in the configuration's dtype (a serving Detector casts its own
    copy). Built under the device, so that the program's own initial draw,
    which the weights replace, is made there."""
    from fdtpu_torch.models import DTYPES, build_model

    prog = family(config)
    with torch.device(device):
        net = build_model(prog.MODEL, prog.model_config(config), device,
                          compute_dtype=DTYPES[config["compute_dtype"]] if train else None)
    net.load_state_dict(weights, strict=True)
    return net
