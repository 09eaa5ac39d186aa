"""Metric logging: console + append-only text log + JSONL + TensorBoard.
A copy of ``fdtpu/utils/logging.py`` whose primary process is rank 0 of
``torch.distributed`` when a process group is initialised.

Reproduces the reference's observability surface (the reference's ``models/
ModelMeta.py:241-313``): per-epoch loss/IoU/recall/precision/F1 printed to the
console, appended to a text log file (``logs/out_<name>.log``), streamed as
JSONL (one object per epoch), and written as real TensorBoard scalar events
(``<log dir>/tb/events.out.tfevents.*`` — the reference's ``self.log`` →
TensorBoard path, ``ModelMeta.py:226,258-287``; encoder in
``fdtpu_torch/utils/tb.py``, no tensorboard package needed).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


def _is_primary_process() -> bool:
    """Only rank 0 owns the log/TB artifacts when a process group is
    initialised (every process computes identical replicated metrics; N
    writers to one file would interleave/duplicate); a lone process is
    primary."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricLogger:
    def __init__(self, log_path: str | Path = "logs/out.log",
                 tensorboard: bool = True):
        self.primary = _is_primary_process()
        self.log_path = Path(log_path)
        self.jsonl_path = self.log_path.with_suffix(".jsonl")
        self._tb = None
        if not self.primary:
            return
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        if tensorboard:
            from fdtpu_torch.utils.tb import EventWriter

            self._tb = EventWriter(self.log_path.parent / "tb")

    def log_epoch(self, epoch: int, split: str, metrics: dict) -> str:
        """Format + emit one epoch's metrics. Returns the formatted line."""
        parts = [f"epoch={epoch}", f"split={split}"]
        parts += [
            f"{k}={float(v):.6f}" for k, v in metrics.items()
        ]
        line = "  ".join(parts)
        if not self.primary:
            return line
        print(line)
        with self.log_path.open("a") as f:
            f.write(line + "\n")
        with self.jsonl_path.open("a") as f:
            record = {
                "time": time.time(),
                "epoch": epoch,
                "split": split,
                **{k: float(v) for k, v in metrics.items()},
            }
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            # epoch as the TensorBoard step; Lightning-style split/metric tags
            self._tb.add_scalars(
                epoch, {k: float(v) for k, v in metrics.items()},
                prefix=f"{split}/",
            )
        return line
