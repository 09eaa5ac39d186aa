"""The modes a traffic mix names by its ``mode`` key: each a module here
with a ``Cell`` class that builds the program for one cell, warms it up,
runs the measured or the traced window, releases the program and checks
what it produced against the plain reference.

* ``train``: training epochs of the program's Trainer (``modes/train.py``);
* ``stream``: frames through the program's serving Detector
  (``modes/stream.py``).
"""

import importlib


def cell_class(mode: str):
    return importlib.import_module(f"perfbench.modes.{mode}").Cell
