"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds,
for the dry runs: the same modes, reference and judge, the program on
the CPU (its kernels' plain versions)."""

from __future__ import annotations

import time

import torch

from perfbench import cell

TINY_MODELS = {
    "poolresnet": dict(filters=8, input_shape=[64, 64], num_patches=2, num_residual_blocks=2,
                       output_kernel_size=3),
    "ssd": dict(filters=4, input_shape=[64, 64], patch_sizes=[8, 4, 2, 1]),
}


def spec(name: str, compute_dtype: str | None = None) -> cell.Spec:
    s = cell.load(name)
    c = s.config
    c["model"].update(TINY_MODELS[c["family"]])
    c["train"].update(batch_size=4, epoch_fraction=min(c["train"]["epoch_fraction"], 2))
    c["train_images"] = 24
    if compute_dtype:
        c["compute_dtype"] = compute_dtype
    s.mix.update(frame_pool=4, trace_frames=40)
    return s


def run(name: str, seed: int = 2**40 + 7, trace: bool = False, limits=None, tmp_path=None,
        compute_dtype: str | None = "float32", seconds: float = 0.3) -> dict:
    return cell.run(spec(name, compute_dtype), seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), tmp_path, limits)
