"""ctypes bindings and the build of the C++ JPEG loader (fdtpu's
``native/loader.py``).

``fast_loader.cpp`` (the port's copy) decodes with libjpeg-turbo, scaling
inside the inverse DCT, and resizes bilinearly in fixed point, with a
threaded batch path. It is built at first use (``native/build.py``) against
the first libjpeg with which it links and loads:

* the compiler's own (``jpeglib.h`` and ``-ljpeg``), with an rpath to the
  directory the linker took ``libjpeg.so`` from, so that the dynamic loader
  finds the library the linker found;
* else the libjpeg-turbo that Pillow's wheel bundles
  (``pillow.libs/libjpeg-*.so.62*``, the libjpeg 6.2 ABI), with the 6.2 API
  headers kept in ``native/include`` and an rpath to ``pillow.libs``. A
  machine with Pillow from its wheel but without libjpeg's development
  files takes this route.

Where neither builds and loads, :func:`native_available` is False and a
decode through the loader raises. The data source decodes through it
wherever it is available (``fdtpu_torch/data/pipeline.py``, fdtpu's rule).
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np

from fdtpu_torch.native.build import HERE

LOADER = HERE / "fast_loader.cpp"
INCLUDE = HERE / "include"
HEADERS = tuple(sorted(INCLUDE.glob("*.h")))
LINK = ("-shared", "-fPIC", "-pthread")


def system_libjpeg() -> tuple[str, ...]:
    """Link flags for the compiler's own libjpeg: ``-ljpeg``, and an rpath
    to the directory of the ``libjpeg.so`` the compiler finds, if it finds
    one."""
    try:
        found = subprocess.run(["g++", "-print-file-name=libjpeg.so"], capture_output=True,
                               text=True, timeout=60).stdout.strip()
    except OSError:
        found = ""
    rpath = (f"-Wl,-rpath,{Path(found).resolve().parent}",) if os.path.isabs(found) else ()
    return ("-ljpeg", *rpath)


def bundled_libjpeg() -> tuple[str, ...] | None:
    """Link flags for the libjpeg-turbo of Pillow's wheel, with the headers
    of ``native/include``; None where Pillow bundles none."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    libs = sorted((Path(spec.origin).parents[1] / "pillow.libs").glob("libjpeg*.so.62*"))
    if not libs:
        return None
    return (f"-I{INCLUDE}", str(libs[0]), f"-Wl,-rpath,{libs[0].parent}")


def build() -> Path:
    """The loader's shared library, built if needed against the first
    libjpeg with which it links and loads (the compiler's own, else
    Pillow's); raises where none does."""
    from fdtpu_torch.native.build import gxx_build

    errors = []
    for libjpeg in (system_libjpeg(), bundled_libjpeg()):
        if libjpeg is None:
            continue
        deps = HEADERS if f"-I{INCLUDE}" in libjpeg else ()
        try:
            path = gxx_build("libfastloader", (LOADER,), (*LINK, *libjpeg), ".so", deps=deps)
            ctypes.CDLL(str(path))
            return path
        except (RuntimeError, OSError) as e:
            errors.append(str(e))
    raise RuntimeError("the native loader links and loads with no libjpeg:\n"
                       + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None where it cannot be built or loaded (a
    machine may link against a libjpeg that its loader does not find)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    lib.fdtpu_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fdtpu_decode_resize.restype = ctypes.c_int
    lib.fdtpu_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.fdtpu_decode_resize_batch.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native loader could not be built or loaded (g++ and libjpeg)")
    return lib


def decode_resize(jpeg_bytes: bytes, out_h: int, out_w: int):
    """Decode and resize one JPEG -> ``(img uint8 (out_h, out_w, 3),
    (src_w, src_h))``. Raises ValueError when the decode fails (the data
    source then substitutes a neighbour)."""
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    sw, sh = ctypes.c_int(), ctypes.c_int()
    rc = _lib().fdtpu_decode_resize(
        jpeg_bytes, len(jpeg_bytes), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(sw), ctypes.byref(sh),
    )
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out, (sw.value, sh.value)


def decode_resize_batch(jpeg_list: list[bytes], out_h: int, out_w: int, num_threads: int = 0):
    """Threaded batch decode -> ``(imgs (n, H, W, 3) uint8, src_dims (n, 2),
    n_failures)``. Failed slots are zero with source dims ``(-1, -1)``."""
    lib = _lib()
    n = len(jpeg_list)
    blob = b"".join(jpeg_list)
    offsets = np.zeros(n, dtype=np.int64)
    sizes = np.asarray([len(b) for b in jpeg_list], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    dims = np.empty((n, 2), dtype=np.int32)
    fails = lib.fdtpu_decode_resize_batch(
        ctypes.cast(ctypes.c_char_p(blob), ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads,
    )
    return out, dims, fails
