"""Checkpoints of the train state (``fdtpu/train/checkpoint.py``), with
``torch.save``.

A checkpoint is one file, ``<dir>/step_%08d.pt``, holding the step, the
module's ``state_dict`` (float32 params) and the optimizer's ``state_dict``
(Adam's moments and step counts). The train step draws every random number
from its generator reseeded from ``(seed, step)`` (``train/step.py``), so a
resumed run continues bit for bit without a generator state. A
variables-only checkpoint, ``{"step": 0, "module": ...}``, serves
inference (:func:`restore_variables`). fdtpu's Orbax checkpoints need jax to
read: ``convert_fdtpu_checkpoint.py`` at the root of the repository turns
them into either form, where jax is installed.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from fdtpu_torch.train.state import TrainState


def checkpoint_path(ckpt_dir: str | Path, step: int) -> Path:
    """Where the checkpoint of ``step`` lives: ``<ckpt_dir>/step_<step>.pt``."""
    return Path(ckpt_dir).absolute() / f"step_{step:08d}.pt"


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, step: int | None = None) -> Path:
    """Write ``state`` to ``<ckpt_dir>/step_<step>.pt`` (the state's step by
    default) and return the path. The file is written under a temporary
    name and renamed into place."""
    path = checkpoint_path(ckpt_dir, int(state.step) if step is None else step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(
        {"step": int(state.step), "module": state.module.state_dict(),
         "optimizer": state.optimizer.state_dict()},
        tmp,
    )
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(ckpt_dir.glob("step_*.pt"))
    return steps[-1] if steps else None


def _load(path: str | Path, device) -> dict:
    return torch.load(Path(path), map_location=device, weights_only=True)


def restore_checkpoint(path: str | Path, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template`` in place (its module's and
    optimizer's shapes must match) and return it. The file is read to the
    host: ``load_state_dict`` copies each tensor to its param's device, and
    keeps Adam's step counts on the host, where ``torch.optim`` keeps them."""
    ckpt = _load(path, "cpu")
    if "optimizer" not in ckpt:
        raise ValueError(f"{path} holds no optimizer state to resume from (a variables-only "
                         f"checkpoint, keys {sorted(ckpt)}): restore_variables reads it")
    template.module.load_state_dict(ckpt["module"])
    template.optimizer.load_state_dict(ckpt["optimizer"])
    template.step = int(ckpt["step"])
    return template


def restore_variables(path: str | Path, device: torch.device | str = "cpu") -> dict:
    """A checkpoint's module params only, as a ``state_dict`` on ``device``,
    for inference (no optimizer needed)."""
    ckpt = _load(path, device)
    if "module" not in ckpt:
        raise ValueError(f"unrecognized checkpoint structure at {path}: {list(ckpt)}")
    return ckpt["module"]
