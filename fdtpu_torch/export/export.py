"""Serialized predict programs through ``torch.export`` (fdtpu's
``export/export.py``, which writes StableHLO).

The reference ships TorchScript and ONNX artifacts with decode+NMS inside
the graph. Here the same program is a module, :class:`PredictProgram`:
``(B, H, W, 3)`` float frames in [0, 255] -> ``/255`` -> the detector's eval
forward -> the fused decode+filter+NMS, K1, as the registered op
``fdtpu_torch::decode_filter_nms``, with fixed-capacity outputs
``(boxes (B, capacity, 5), mask (B, capacity))``.

* :func:`export_predict` exports it with a static batch and saves the
  ``ExportedProgram`` (``.pt2``, weights included);
* :func:`load_exported` loads one back as a callable module;
* :func:`aot_compile_predict` is fdtpu's "compiled for the local device, no
  tracing at serving time": on the card the exported program captured once
  in a CUDA graph and replayed (:class:`GraphPredict`); on the CPU, asked
  for by name, the exported module itself.

Export on the device the artifact will serve on: the program's tensors,
its weights and decode tables included, keep the device they were
exported on.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch
from torch import nn

from fdtpu_torch.kernels.nms import (
    _f32,
    decode_filter_nms_batch,
    grid_tables_on,
    ssd_output_tables_on,
)
from fdtpu_torch.models.detector import Detector, is_ssd, refuse_served_only
from fdtpu_torch.utils.graphs import capture_body, clone_outputs


class PredictProgram(nn.Module):
    """fdtpu's ``make_predict_fn`` as a module: ``forward(images)`` takes
    ``(B, H, W, 3)`` float frames in [0, 255] at the model's input size and
    returns ``(boxes, mask)``, the reference's predict minus the host
    resize. The net is the one :meth:`Detector.apply` runs (a copy of
    ``model`` in ``dtype``, channels_last, BatchNorm in float32); the decode
    tables are buffers, made once; the thresholds are rounded to float32,
    as K1 takes them. Thresholds and capacity default to the reference
    converter's."""

    def __init__(self, model: nn.Module, probability_threshold: float = 0.7,
                 iou_threshold: float = 0.01, capacity: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        refuse_served_only(model, "a .pt2 export")
        det = Detector(model, probability_threshold, iou_threshold, capacity, dtype)
        self.net = det.net
        self.input_shape = tuple(model.input_shape)
        h, w = self.input_shape
        if is_ssd(model):
            n = sum(ps * ps for ps in model.patch_sizes)
            tables = ssd_output_tables_on(n, (w, h), det.device)
        else:
            tables = grid_tables_on(model.grid_size(), (w, h), det.device)
        for name, col in zip(("sx", "ox", "sy", "oy"), tables[:4]):
            self.register_buffer(name, col.clone())
        self.w_scale, self.h_scale = (_f32(v) for v in tables[4:])
        self.probability_threshold = _f32(probability_threshold)
        self.iou_threshold = _f32(iou_threshold)
        self.capacity = capacity

    @property
    def device(self) -> torch.device:
        return self.sx.device

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out = self.net(images.float() / 255.0)
        rows = out.reshape(out.shape[0], -1, 5)
        tables = (self.sx, self.ox, self.sy, self.oy, self.w_scale, self.h_scale)
        return decode_filter_nms_batch(rows, tables, self.probability_threshold,
                                       self.iou_threshold, self.capacity)


def export_program(program: PredictProgram, batch_size: int = 1) -> torch.export.ExportedProgram:
    """``torch.export`` of ``program`` at a static ``(batch_size, H, W, 3)``
    float32 input on the program's device."""
    h, w = program.input_shape
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.float32, device=program.device)
    with torch.no_grad():
        return torch.export.export(program, (example,), strict=False)


def export_predict(
    model: nn.Module,
    path: str | Path,
    batch_size: int = 1,
    probability_threshold: float = 0.7,
    iou_threshold: float = 0.01,
    capacity: int = 64,
    dtype: torch.dtype = torch.bfloat16,
) -> Path:
    """Export ``model``'s predict program (:class:`PredictProgram`, on the
    model's device) at a static batch and save it to ``path`` with
    ``torch.export.save``. Thresholds default to the reference
    converter's."""
    program = PredictProgram(model, probability_threshold, iou_threshold, capacity, dtype)
    exported = export_program(program, batch_size)
    exported.example_inputs = None  # the zero frames it was traced on stay out of the file
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with warnings.catch_warnings():
        # the channels_last weights are dense but not contiguous, which the
        # saver reports; each is saved with its whole storage and strides
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(exported, path)
    return path


def load_exported(path: str | Path) -> nn.Module:
    """A saved predict program as a module, ``(images) -> (boxes, mask)``.
    Loading validates the artifact; the kernels module is imported first,
    which registers the op the program calls."""
    import fdtpu_torch.kernels  # noqa: F401  registers fdtpu_torch::decode_filter_nms

    return torch.export.load(Path(path)).module()


class GraphPredict:
    """A predict program captured once in a CUDA graph with a static input
    buffer (``utils/graphs.py``). A call copies the frames into the buffer,
    replays the graph and returns copies of the outputs. The frames must
    have the shape it was captured at. K1's launch is captured with the
    rest: :attr:`graph`'s ``per_replay`` holds the launches a replay makes,
    and :attr:`replays` counts the replays."""

    def __init__(self, fn: nn.Module, example: torch.Tensor, warmup: int = 3):
        with torch.no_grad():
            self.graph = capture_body(fn, (example.clone(),), warmup=warmup)
        self.input = self.graph.inputs[0]

    @property
    def replays(self) -> int:
        return self.graph.replays

    def __call__(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if images.shape != self.input.shape:
            raise ValueError(f"captured at {tuple(self.input.shape)}, got {tuple(images.shape)}")
        self.input.copy_(images)
        return clone_outputs(self.graph.replay())


def aot_compile_predict(
    model: nn.Module,
    batch_size: int = 1,
    probability_threshold: float = 0.7,
    iou_threshold: float = 0.01,
    capacity: int = 64,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """``model``'s predict program exported at ``batch_size`` and prepared
    for ``device``, where nothing is traced at serving time: on a card a
    :class:`GraphPredict` of the exported program (a failed capture
    raises); on the CPU, which the caller names, the exported module."""
    device = torch.device(device)
    program = PredictProgram(model, probability_threshold, iou_threshold, capacity,
                             dtype).to(device)
    exported = export_program(program, batch_size).module()
    if device.type == "cpu":
        return exported
    h, w = program.input_shape
    return GraphPredict(exported, torch.zeros((batch_size, h, w, 3), device=device))
