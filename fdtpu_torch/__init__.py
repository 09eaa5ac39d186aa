"""fdtpu_torch — the PyTorch + CUDA port of fdtpu, for NVIDIA Hopper (H100).

The JAX package ``fdtpu`` is the reference; this package sits beside it and
mirrors its layout (``core/``, ``kernels/``, ``models/``, ``compat/``,
``data/``, ``losses/``, ``train/``, ``parallel/``, ``utils/``) so each
module's counterpart is found under the same name. It
imports torch, numpy and PIL, never jax, flax, optax or fdtpu.

Conventions kept from fdtpu at every public function:

* images are ``(B, H, W, 3)`` NHWC; the models run NCHW in channels_last
  memory format inside;
* grid maps are ``(B, S, S, 5)`` indexed ``[y_cell, x_cell]`` with channels
  ``(conf, x, y, w, h)``;
* boxes are fixed-capacity ``(B, capacity, 5)`` rows ``[score, x, y, w, h]``
  in pixels plus a ``(B, capacity)`` bool mask.

Every Pallas kernel of fdtpu that the port carries becomes a kernel written
by hand for Hopper (``kernels/csrc/``), with a plain PyTorch version beside
it that serves CPU tensors and is the kernel's oracle on the card.
"""

__version__ = "0.1.0"

from fdtpu_torch.utils.config import DetectorConfig  # noqa: F401
