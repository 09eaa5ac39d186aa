"""The one count of kernel launches (``fdtpu_torch/kernels/launches.py``):
each kernel module counts its own launches in ``LAUNCHES`` and keeps no
count of its own, and the CUDA-graph helper (``utils/graphs.py``) names no
kernel. Read from the sources, so no card is needed."""

import ast
import importlib
import inspect
from pathlib import Path

import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = Path(__file__).resolve().parents[1]
KERNELS = REPO / "fdtpu_torch" / "kernels"

# the names each module counts under
COUNTS = {
    "bn_act": {"bn_act"},
    "conv_gemm": {"conv_gemm"},
    "epilogue": {"residual_tail"},
    "nms": {"decode_filter_nms", "decode_filter_nms_scratch"},
    "photometric": {"photometric"},
    "rotate": {"shear_rows", "shear_rows_stacked", "shear_cols"},
}


def kernel_imports(path: Path) -> list[tuple[str, list[str]]]:
    """Every import of a ``fdtpu_torch.kernels`` module in a file, at any
    depth: ``(module, names)``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [(a.name, []) for a in node.names
                      if a.name.startswith("fdtpu_torch.kernels")]
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "fdtpu_torch.kernels"):
            found.append((node.module, [a.name for a in node.names]))
    return found


def test_graph_helper_names_no_kernel():
    """The graph helper reads the counter alone: adding a kernel touches
    only its own module."""
    found = kernel_imports(REPO / "fdtpu_torch" / "utils" / "graphs.py")
    assert found == [("fdtpu_torch.kernels", ["LAUNCHES"])], found


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_kernel_module_counts_through_launches(name):
    """The module adds one to ``LAUNCHES[<its names>]`` where it launches,
    and sets no attribute whose name ends in ``launches`` on anything."""
    tree = ast.parse((KERNELS / f"{name}.py").read_text())
    bumped, attrs = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.AugAssign):
            t = node.target
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "LAUNCHES"):
                assert isinstance(t.slice, ast.Constant) and isinstance(node.op, ast.Add)
                bumped.add(t.slice.value)
        for t in getattr(node, "targets", [getattr(node, "target", None)]):
            if isinstance(t, ast.Attribute) and t.attr.endswith("launches"):
                attrs.append(t.attr)
    assert bumped == COUNTS[name]
    assert not attrs, attrs
    assert ("fdtpu_torch.kernels.launches", ["LAUNCHES"]) in kernel_imports(KERNELS / f"{name}.py")
    module = importlib.import_module(f"fdtpu_torch.kernels.{name}")
    for fn_name, fn in inspect.getmembers(module, inspect.isfunction):
        assert not [a for a in vars(fn) if a.endswith("launches")], fn_name
