"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/fdtpu_torch/`` at the root of the checkout, named by
a hash of the sources and flags, so the first use after a change builds it
and every later process loads it. Nothing outside the package's own sources
is compiled, and this module is imported only when a kernel is launched, so
a machine without ``nvcc`` never needs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fdtpu_torch"
# -fmad=false: no multiply-add is contracted into an FMA, so decoded corners
# and IoUs round exactly like the plain version's separate ops.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfdtpu_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # one nvcc per source, all started together, then one link; everything
    # goes to a private directory and the library is renamed into place, so
    # a concurrent build never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [(p.args[-3], p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src}:\n{log}" for src, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument types (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build()))
    lib.fdtpu_decode_filter_nms.argtypes = [
        _P, _P, _P, _P, _P, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P,
    ]
    lib.fdtpu_decode_filter_nms.restype = _I
    lib.fdtpu_decode_filter_nms_scratch.argtypes = [
        _P, _P, _P, _P, _P, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P,
    ]
    lib.fdtpu_decode_filter_nms_scratch.restype = _I
    lib.fdtpu_decode_filter_nms_indexed.argtypes = [
        _P, _P, _P, _P, _P, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P,
    ]
    lib.fdtpu_decode_filter_nms_indexed.restype = _I
    lib.fdtpu_decode_filter_nms_scratch_floats.argtypes = [_I]
    lib.fdtpu_decode_filter_nms_scratch_floats.restype = ctypes.c_longlong
    lib.fdtpu_decode_filter_nms_max_candidates.argtypes = [_I, ctypes.POINTER(_I)]
    lib.fdtpu_decode_filter_nms_max_candidates.restype = _I
    lib.fdtpu_shear_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.fdtpu_shear_rows.restype = _I
    lib.fdtpu_shear_cols.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    lib.fdtpu_shear_cols.restype = _I
    lib.fdtpu_photometric.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.fdtpu_photometric.restype = _I
    lib.fdtpu_residual_tail.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.fdtpu_residual_tail.restype = _I
    lib.fdtpu_bn_act.argtypes = [_P, _P, _P, _P, _P, _P, _P, _F, _I, _F, _I, _I, _I, _P]
    lib.fdtpu_bn_act.restype = _I
    lib.fdtpu_cuda_error_string.argtypes = [_I]
    lib.fdtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cuda_error_string(err: int) -> str:
    """``cudaGetErrorString`` for a code an entry point returned."""
    return f"cudaError {err}: {load_library().fdtpu_cuda_error_string(err).decode()}"
