"""ctypes bindings and the build of the native ``.fdn`` engine (fdtpu's
``native/infer.py``).

:func:`fdtpu_torch.export.export_native` writes a ``.fdn`` artifact (a flat
op program and float32 weights); this engine, dependency-free C++ of the
port's own (``infer_engine.cpp``, a copy of the JAX package's), runs the
whole predict program on the host: ``/255``, the conv stack, sigmoid, the
grid or SSD-prior decode and NMS, for every family of the zoo (BatchNorm
folded at export). It is the counterpart of the reference's TorchScript
lite interpreter and onnxruntime serving; the exported program
(``fdtpu_torch.export``) is the serving artifact for the card.

A standalone CLI (``fdn_serve``: JPEG in, JSON boxes out, no Python) builds
through :func:`build_cli`. Both build with ``g++`` at first use
(``native/build.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from fdtpu_torch.native.build import HERE

ENGINE = HERE / "infer_engine.cpp"
CLI = HERE / "serve_main.cpp"
LOADER = HERE / "fast_loader.cpp"


def build() -> Path:
    """The engine's shared library, built if needed."""
    from fdtpu_torch.native.build import gxx_build

    return gxx_build("libfdn_infer", (ENGINE,), ("-shared", "-fPIC", "-pthread"), ".so")


def build_cli() -> Path:
    """The standalone ``fdn_serve`` binary (the engine and the libjpeg
    decode), built if needed."""
    from fdtpu_torch.native.build import gxx_build

    return gxx_build("fdn_serve", (CLI, ENGINE, LOADER), ("-ljpeg", "-pthread"))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.fdn_load.argtypes = [ctypes.c_char_p]
    lib.fdn_load.restype = ctypes.c_void_p
    lib.fdn_free.argtypes = [ctypes.c_void_p]
    lib.fdn_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.fdn_info.restype = ctypes.c_int
    lib.fdn_predict.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.fdn_predict.restype = ctypes.c_int
    return lib


class NativeDetector:
    """A loaded ``.fdn`` model; :meth:`predict` keeps ``Detector``'s decode
    contract (``boxes (B, capacity, 5)`` rows ``[score, x, y, w, h]`` in
    pixels, and a mask), with no ML framework in the call."""

    def __init__(self, path: str | Path):
        lib = load_library()
        self._lib = lib
        self._h = lib.fdn_load(str(path).encode())
        if not self._h:
            raise ValueError(f"failed to load .fdn artifact: {path}")
        ih, iw, cap = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.fdn_info(self._h, ctypes.byref(ih), ctypes.byref(iw), ctypes.byref(cap))
        self.input_shape = (ih.value, iw.value)
        self.capacity = cap.value

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fdn_free(self._h)
            self._h = None

    def predict(self, images: np.ndarray, num_threads: int = 0):
        """``images``: ``(B, H, W, 3)`` or ``(H, W, 3)`` uint8 or float in
        [0, 255] at the model's input size (the engine divides by 255).
        Returns ``(boxes (B, capacity, 5), mask (B, capacity))``; 0 threads
        means one a core."""
        imgs = np.asarray(images, dtype=np.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        b = imgs.shape[0]
        h, w = self.input_shape
        if imgs.shape[1:] != (h, w, 3):
            raise ValueError(f"expected (B, {h}, {w}, 3), got {imgs.shape}")
        imgs = np.ascontiguousarray(imgs)
        boxes = np.empty((b, self.capacity, 5), dtype=np.float32)
        mask = np.empty((b, self.capacity), dtype=np.uint8)
        rc = self._lib.fdn_predict(
            self._h, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads,
        )
        if rc != 0:
            raise RuntimeError("fdn_predict failed")
        return boxes, mask.astype(bool)
