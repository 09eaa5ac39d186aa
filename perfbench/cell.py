"""One run of one cell: the cell's entry of ``BENCHMARK.json`` and the
files its names lead to, the run itself, and its result line.

A run builds the cell (the module its mix's ``mode`` names), sets it up, then
either measures for ``seconds`` (``--trace 0``: the cell's end-to-end
metrics, ``setup_s`` from the process's start to the first timed unit of
work) or runs the traced window (``--trace 1``: the cell's per-layer
metrics, each from its reader in ``layer_metrics/``). After the window it
reads the card's memory peak, frees the program, runs the plain reference
and judges the outputs against the cell's limits.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import torch

from perfbench import judge
from perfbench.modes import cell_class
from perfbench.roofline.peaks import peaks

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fdtpu")


@dataclasses.dataclass
class Spec:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load(name: str, bench: dict | None = None) -> Spec:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix
    and metrics."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Spec(
        name=name, chips=cell["chips"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.layer_metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """The JAX stack's and the JAX package's modules this process holds,
    by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, workdir: Path | None = None, limits: dict | None = None) -> dict:
    """One run -> the result line's object (``checks`` last)."""
    workdir = workdir or Path(tempfile.gettempdir()) / "perfbench"
    workdir.mkdir(parents=True, exist_ok=True)
    cell = cell_class(spec.mix["mode"])(spec.name, spec.config, spec.mix, seed, device, workdir)
    cell.setup()
    if trace:
        window, units, failed = cell.traced()
    else:
        t0, e2e, units, failed = cell.window(seconds)
        e2e["setup_s"] = t0 - t_start
    if forbidden_modules():
        raise RuntimeError(f"the run holds {forbidden_modules()} after its window")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.release()
    numbers, bad = cell.check()
    failed += bad
    correct, checks = judge.verdict(numbers, limits or judge.limits(spec.name))
    for name in sorted(set(numbers) - set(checks)):  # read, but held to no limit
        print(f"look {name} {numbers[name]!r}", file=sys.stderr)
    kind = device_kind(device)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": spec.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": units, "failed": failed}
    if trace:
        ctx = {"window": window, "units": units, "peak": peaks(kind), **cell.layer_context()}
        metrics = {}
        for m in spec.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=window.busy_s, window_s=window.window_s)
        out.update(metrics=metrics, device=dev, breakdown=window.breakdown())
    else:
        out.update(metrics={m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                            for m in spec.end_to_end}, device=dev)
    out["checks"] = checks
    return out
