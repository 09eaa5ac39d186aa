"""Build the port's C++ host code (the ``.fdn`` engine, its CLI and the
JPEG loader) with ``g++``.

Each output is named by a digest of its sources and flags and lands in
``build/fdtpu_torch/`` at the root of the checkout (git-ignored), so the
first use after a change builds it and every later process loads it. A
build writes into a private directory and renames the result into place,
so a concurrent process (a test worker) never loads a half-written file.
The first of the architecture flags the compiler takes is used; when
``g++`` fails with all of them, the build raises.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "fdtpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17")
ARCH_FLAGS = (("-march=native",), ("-mavx2", "-mfma"), ())


def output_path(stem: str, sources: tuple[Path, ...], args: tuple[str, ...],
                deps: tuple[Path, ...] = ()) -> Path:
    """Where the build of ``sources`` (and the headers ``deps`` they
    include) with ``args`` lives."""
    digest = hashlib.sha256(" ".join((*GXX_FLAGS, *args, *map(" ".join, ARCH_FLAGS))).encode())
    for src in (*sources, *deps):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}"


def gxx_build(stem: str, sources: tuple[Path, ...], args: tuple[str, ...],
              suffix: str = "", deps: tuple[Path, ...] = ()) -> Path:
    """Compile ``sources`` with ``args`` (link flags after the sources)
    unless the output for them exists; returns its path."""
    out = output_path(stem, sources, args, deps).with_suffix(suffix)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        target = os.path.join(tmp, out.name)
        for arch in ARCH_FLAGS:
            cmd = ["g++", *GXX_FLAGS, *arch, *map(str, sources), *args, "-o", target]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode == 0:
                os.replace(target, out)
                return out
            logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("g++ failed:\n" + "\n".join(logs))
