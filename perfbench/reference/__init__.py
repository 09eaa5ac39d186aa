"""Plain PyTorch references of the benchmark's configurations.

Each family is a module of functions over a dict of float32 tensors named
as the program's ``state_dict``: ``param_specs(model)`` (names, shapes and
initialisers, from which ``perfbench/weights.py`` draws the weights that
both sides get), ``forward(params, images, model, precision, masks)``, and
whatever else the generic code needs of a family (``perfbench/families.py``
lists it): its FLOPs, the width of its rows, its decode, the biases that
set its scores, its targets and loss, and its size for the CPU dry runs.
The augmentation, the losses' parts, SAM with Adam and greedy NMS are
shared, frozen copies of the program's semantics, written over again in
float32. Nothing here imports ``fdtpu_torch`` or the JAX package,
and nothing takes a tensor the program made: the references work out the
augmentation draws, the targets and the row order again from the seed.

Float32 here is float32: :func:`strict_float32` turns TF32 off in cuDNN
and cuBLAS while a reference runs and restores the flags after it.
"""

import contextlib

import torch

from perfbench import families


@contextlib.contextmanager
def strict_float32():
    """TF32 off for cuDNN's convolutions and cuBLAS's matmuls, restored on
    exit (the program runs with the defaults)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def family(name: str):
    """The reference module of a configuration's ``reference`` key,
    ``reference/<name>.py`` (``perfbench/families.py``)."""
    return families.load("reference", name)
