"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds,
for the dry runs: the same modes, reference and judge, the program on
the CPU (its kernels' plain versions). A family's size here is its
reference module's ``TINY``."""

from __future__ import annotations

import json
import time

import torch

from perfbench import cell, reference


def cells(mode: str, bench: dict | None = None) -> list[str]:
    """The cells of ``BENCHMARK.json`` whose traffic mix has ``mode``."""
    bench = bench or json.loads((cell.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]
            if json.loads((cell.HERE / "traffic" / f"{w['traffic']}.json").read_text())["mode"]
            == mode]


def spec(name: str, compute_dtype: str | None = None, bench: dict | None = None) -> cell.Spec:
    s = cell.load(name, bench)
    c = s.config
    c["model"].update(reference.family(c["reference"]).TINY)
    c["train"].update(batch_size=4, epoch_fraction=min(c["train"]["epoch_fraction"], 2))
    c["train_images"] = 24
    if compute_dtype:
        c["compute_dtype"] = compute_dtype
    s.mix.update(frame_pool=4, trace_frames=40)
    return s


def run(name: str, seed: int = 2**40 + 7, trace: bool = False, limits=None, tmp_path=None,
        compute_dtype: str | None = "float32", seconds: float = 0.3,
        bench: dict | None = None) -> dict:
    return cell.run(spec(name, compute_dtype, bench), seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), tmp_path, limits)
