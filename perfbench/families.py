"""Where a model family's code lives, found by name.

A configuration file names its family twice: ``reference`` is the module
``reference/<reference>.py``, the plain float32 reference, and ``family``
is the module ``programs/<family>.py``, how the program is built. The
generic harness reaches a family only through these two modules, so a
family is added as new files alone. Each module holds the names that
``NEEDS`` lists; a family that lacks its module or one of those names
fails at set-up, naming the file.
"""

from __future__ import annotations

import importlib
import re

NEEDS = {
    # ROW: the width of a model row; TINY: the model's sizes for the CPU dry runs;
    # param_specs, forward: the weights' layout and the float32 forward;
    # flop_counts: the forward's FLOPs of one image and its first layer's;
    # score_heads: the biases that set the scores (weights.center_scores);
    # candidates: one frame's rows -> scores and [x0, y0, w, h] boxes;
    # targets, loss: a training step's targets and loss (reference/train.follow);
    # box_rows: the leaves' rows that write box coordinates (judge's box_grad_gap).
    "reference": ("ROW", "TINY", "param_specs", "forward", "flop_counts", "score_heads",
                  "candidates", "targets", "loss", "box_rows"),
    # MODEL: the name the program's build_model takes; model_config: the program's
    # config object; loss_kwargs: the Trainer's loss arguments.
    "programs": ("MODEL", "model_config", "loss_kwargs"),
}
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, holding every name of
    ``NEEDS[kind]``."""
    path = f"perfbench/{kind}/{name}.py"
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a family's module name ({path})")
    module = f"perfbench.{kind}.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(f"no {path}: a family named {name!r} adds it, with "
                          f"{', '.join(NEEDS[kind])}") from None
    missing = [n for n in NEEDS[kind] if not hasattr(mod, n)]
    if missing:
        raise LookupError(f"{path} lacks {', '.join(missing)}")
    return mod
