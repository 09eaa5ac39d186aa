"""fdtpu_torch imports no JAX and nothing of fdtpu. Checked in a fresh
interpreter, because this test process has imported jax already."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import fdtpu_torch
names = ["fdtpu_torch"]
for info in pkgutil.walk_packages(fdtpu_torch.__path__, "fdtpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fdtpu"))
print(len(names), "modules;", "forbidden:", bad)
assert not bad, bad
assert "triton" not in sys.modules and "fdtpu_torch.kernels.build" in names
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 19, proc.stdout  # every module of the package was imported


ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fdtpu"))
assert not bad, bad
assert "triton" not in sys.modules and "fdtpu_torch.kernels.build" not in sys.modules
"""


@pytest.mark.parametrize("module", ["fdtpu_torch.kernels.photometric",
                                    "fdtpu_torch.kernels.epilogue",
                                    "fdtpu_torch.bench_pool_fusion"])
def test_kernel_modules_import_alone_without_jax(module):
    """Each module of the fused kernels, imported on its own: no JAX, no
    fdtpu, and no build until a kernel launches."""
    proc = subprocess.run(
        [sys.executable, "-c", ALONE, module], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
