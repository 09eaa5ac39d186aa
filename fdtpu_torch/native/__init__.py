"""Native (C++) host code of the port, copies of the JAX package's: the
``.fdn`` engine (``infer.py``) and the JPEG loader (``loader.py``). Each
builds with ``g++`` at first use."""

from fdtpu_torch.native.infer import NativeDetector, build_cli  # noqa: F401
from fdtpu_torch.native.loader import (  # noqa: F401
    decode_resize,
    decode_resize_batch,
    native_available,
)
