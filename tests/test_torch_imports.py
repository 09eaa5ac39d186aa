"""fdtpu_torch imports no JAX and nothing of fdtpu. Checked in a fresh
interpreter, because this test process has imported jax already, and in
the source of every module and of ``chip_smoke.py``, where an import inside
a function shows too."""

import ast
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "fdtpu"))
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
    assert count >= 32, proc.stdout  # every module of the package was imported


ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "fdtpu"))
assert not bad, bad
assert "triton" not in sys.modules and "fdtpu_torch.kernels.build" not in sys.modules
"""
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fdtpu"}


@pytest.mark.parametrize("module", ["fdtpu_torch.kernels.photometric",
                                    "fdtpu_torch.kernels.epilogue",
                                    "fdtpu_torch.bench_pool_fusion",
                                    "fdtpu_torch.bench",
                                    "fdtpu_torch.train_model",
                                    "fdtpu_torch.run_validation_epoch",
                                    "fdtpu_torch.load_checkpoint",
                                    "fdtpu_torch.demo_model",
                                    "fdtpu_torch.train.loop",
                                    "fdtpu_torch.data.pipeline",
                                    "fdtpu_torch.train_model_ssd",
                                    "fdtpu_torch.models.ssd",
                                    "fdtpu_torch.core.priors",
                                    "fdtpu_torch.losses.ssd",
                                    "fdtpu_torch.compat.from_fdtpu",
                                    "fdtpu_torch.models.resnet",
                                    "fdtpu_torch.models.separable",
                                    "fdtpu_torch.models.mobilenetv3",
                                    "fdtpu_torch.models.smoke",
                                    "fdtpu_torch.compat.torch_import"])
def test_kernel_modules_import_alone_without_jax(module):
    """Each module of the fused kernels, each entry point, the Trainer
    with its loader, the SSD's modules and the rest of the zoo's (with the
    TorchScript import), imported on its own: no JAX, no fdtpu, and no
    build until a kernel launches."""
    proc = subprocess.run(
        [sys.executable, "-c", ALONE, module], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def imported_roots(path: Path) -> set[str]:
    """The top-level names of every import in a file, at any depth."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


SOURCES = sorted((REPO / "fdtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_even_lazily(path):
    assert not imported_roots(path) & FORBIDDEN
