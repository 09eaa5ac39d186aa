"""Nothing under ``perfbench/`` imports JAX or the JAX package ``fdtpu``
(top-level names compared whole: the port ``fdtpu_torch`` begins with
``fdtpu``), and nothing under ``perfbench/reference/`` imports the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fdtpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert "fdtpu_torch" not in top_level_imports(path)


def test_a_run_loads_no_jax():
    """Importing the harness and the program's modules a run imports
    loads no JAX (the run checks ``sys.modules`` itself after its
    window)."""
    code = ("import sys; sys.path.insert(0, %r); import perfbench.run, perfbench.cell, "
            "perfbench.modes.train, perfbench.modes.stream, perfbench.control; "
            "import fdtpu_torch.train, fdtpu_torch.models, fdtpu_torch.data; "
            "from perfbench.cell import forbidden_modules; print(forbidden_modules())"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
