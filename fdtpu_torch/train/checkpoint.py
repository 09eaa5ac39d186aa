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

A file is the same whichever device wrote it: the learning rate is saved
as a float (a card's capturable Adam holds it as a tensor) and Adam's
``step`` as a float32 0-d tensor. A restore loads into the template's own
tensors (params, buffers, Adam's moments and steps) in place, so that a
train step captured in a CUDA graph before the restore (``train/graphs.py``)
goes on reading the restored state; the template keeps its optimizer's
settings (the rate's tensor, ``capturable``).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from fdtpu_torch.train.state import TrainState, adam_step_count


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
    optimizer = state.optimizer.state_dict()
    for group in optimizer["param_groups"]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
    torch.save({"step": int(state.step), "module": state.module.state_dict(),
                "optimizer": optimizer}, tmp)
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
    host and each tensor copied into the template's own (module docstring);
    Adam's step counts go where the template's optimizer keeps them (the
    card when capturable, the host otherwise)."""
    ckpt = _load(path, "cpu")
    if "optimizer" not in ckpt:
        raise ValueError(f"{path} holds no optimizer state to resume from (a variables-only "
                         f"checkpoint, keys {sorted(ckpt)}): restore_variables reads it")
    template.module.load_state_dict(ckpt["module"])
    _load_optimizer_state(template.optimizer, ckpt["optimizer"])
    template.step = int(ckpt["step"])
    return template


def _load_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)``, keeping the optimizer's param
    group settings and, where a param already has state, its tensors:
    the saved values are copied into them."""
    settings = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    before = {p: dict(optimizer.state[p]) for g in optimizer.param_groups for p in g["params"]
              if optimizer.state.get(p)}
    optimizer.load_state_dict(saved)
    for group, keep in zip(optimizer.param_groups, settings):
        group.update(keep)
    for p, state in optimizer.state.items():
        if "step" in state:
            state["step"] = adam_step_count(optimizer, p, state["step"])
        for key, old in before.get(p, {}).items():
            if key in state and old.shape == state[key].shape:
                state[key] = old.copy_(state[key])


def restore_variables(path: str | Path, device: torch.device | str = "cpu") -> dict:
    """A checkpoint's module params only, as a ``state_dict`` on ``device``,
    for inference (no optimizer needed)."""
    ckpt = _load(path, device)
    if "module" not in ckpt:
        raise ValueError(f"unrecognized checkpoint structure at {path}: {list(ckpt)}")
    return ckpt["module"]
