"""Import weights from the reference's TorchScript checkpoints
(``fdtpu/compat/torch_import.py``).

The reference ships TorchScript archives made by ``to_torchscript``. Their
graphs call torchvision's custom ops, and torchvision is not a dependency,
so :func:`read_torchscript_state_dict` registers schema-only stubs of
``torchvision::nms`` and the two ``_interpolate_*_aa`` ops, enough for
``torch.jit.load`` to deserialize, and reads ``state_dict()``.

Mapping to the port's modules:

* grid models (PoolResnet, Resnet, SeparableCNN): the port keeps the
  reference's names (``conv1``, ``residual_blocks.{i}.conv{1,2}`` or
  ``.pointwise_conv1/.depthwise_conv/.pointwise_conv2``, ``out``), so the
  tensors load as they are;
* MobileNetV3: ``feature_extractor.0/1`` are timm's ``conv_stem``/``bn1``;
  ``feature_extractor.3.{stage}.{j}`` are timm's blocks in its stage layout
  (1, 2, 3, 2, 3 blocks, then the final 1x1 ConvBnAct to 576), flattened to
  ``blocks.{0..10}``; ``out`` is the ``head``. Block 0 is timm's
  DepthwiseSeparableConv, whose ``bn1``/``conv_pw``/``bn2`` are the port's
  ``bn2``/``conv_pwl``/``bn3``. The BatchNorm running statistics come
  across; ``num_batches_tracked`` is dropped (the port's BatchNorm has
  none).

Every tensor's name and shape is checked against the module before
anything loads. The reference's grid convention is spatially transposed
(``fm[:, x_cell, y_cell]``), so :func:`load_reference_detector` wraps a
grid model in :class:`ReferenceLayoutGrid`, which swaps the output's
spatial axes; the port's decoder then gives the reference's boxes.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from fdtpu_torch.models.ssd import SSD

STUB_OPS = (
    ("nms", "(Tensor dets, Tensor scores, float iou_threshold) -> Tensor"),
    ("_interpolate_bilinear2d_aa", "(Tensor input, int[] output_size, bool align_corners) -> Tensor"),
    ("_interpolate_bicubic2d_aa", "(Tensor input, int[] output_size, bool align_corners) -> Tensor"),
)


def _register_stub_ops() -> None:
    for name, schema in STUB_OPS:
        try:
            torch.library.define(f"torchvision::{name}", schema)
        except RuntimeError:
            pass  # already registered in this process


def read_torchscript_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A TorchScript archive's ``state_dict``, on the host."""
    _register_stub_ops()
    archive = torch.jit.load(str(path), map_location="cpu")
    return {k: v.detach() for k, v in archive.state_dict().items()}


# timm's tf_mobilenetv3_small stage layout: blocks a stage, then the final
# ConvBnAct stage
_MNV3_STAGES = (1, 2, 3, 2, 3)
_SE = {"se.conv_reduce": "se.reduce", "se.conv_expand": "se.expand"}
# timm block -> the port's InvertedResidual, by submodule
_DEPTHWISE_SEPARABLE = {"conv_dw": "conv_dw", "bn1": "bn2", "conv_pw": "conv_pwl", "bn2": "bn3",
                        **_SE}
_INVERTED_RESIDUAL = {"conv_pw": "conv_pw", "bn1": "bn1", "conv_dw": "conv_dw", "bn2": "bn2",
                      "conv_pwl": "conv_pwl", "bn3": "bn3", **_SE}


def mobilenetv3_prefixes(sd: dict[str, torch.Tensor]) -> dict[str, str]:
    """The reference MobileNetV3's submodule prefixes -> the port's."""
    prefixes = {"feature_extractor.0": "conv_stem", "feature_extractor.1": "bn1", "out": "head"}
    flat = 0
    for stage, n in enumerate(_MNV3_STAGES):
        for j in range(n):
            t = f"feature_extractor.3.{stage}.{j}"
            separable = f"{t}.conv_pw.weight" in sd and f"{t}.conv_pwl.weight" not in sd
            names = _DEPTHWISE_SEPARABLE if separable else _INVERTED_RESIDUAL
            prefixes.update({f"{t}.{ref}": f"blocks.{flat}.{port}" for ref, port in names.items()})
            flat += 1
    last = f"feature_extractor.3.{len(_MNV3_STAGES)}.0"
    prefixes.update({f"{last}.conv": "conv_576", f"{last}.bn1": "bn_576"})
    return prefixes


def _port_state_dict(sd: dict[str, torch.Tensor], module: nn.Module) -> dict[str, torch.Tensor]:
    """The reference's tensors under the port's names, each checked against
    ``module``'s ``state_dict`` by name and shape; raises on any mismatch."""
    if isinstance(module, MobileNetV3Backbone):
        prefixes = mobilenetv3_prefixes(sd)
        mapped = {}
        for name, tensor in sd.items():
            prefix, leaf = name.rsplit(".", 1)
            if leaf == "num_batches_tracked":
                continue
            if prefix not in prefixes:
                raise ValueError(f"{name}: not in the reference MobileNetV3's layout")
            mapped[f"{prefixes[prefix]}.{leaf}"] = tensor
    else:
        mapped = dict(sd)
    want = module.state_dict()
    missing, unexpected = sorted(set(want) - set(mapped)), sorted(set(mapped) - set(want))
    if missing or unexpected:
        raise ValueError(f"checkpoint does not fit {type(module).__name__}: missing {missing}, "
                         f"unexpected {unexpected}")
    for name, tensor in mapped.items():
        if tensor.shape != want[name].shape:
            raise ValueError(f"{name}: checkpoint {tuple(tensor.shape)} != model "
                             f"{tuple(want[name].shape)}")
    return mapped


def load_torchscript_weights(path: str | Path, module: nn.Module) -> nn.Module:
    """Load a reference checkpoint into ``module`` in place (a grid model or
    MobileNetV3), every tensor's name and shape checked first."""
    module.load_state_dict(_port_state_dict(read_torchscript_state_dict(path), module))
    return module


def load_reference_detector(path: str | Path, module: nn.Module) -> nn.Module:
    """Load a reference checkpoint into ``module`` and return the model to
    serve or validate: a grid model (MobileNetV3 included) wrapped in
    :class:`ReferenceLayoutGrid`, so that decoded boxes are the
    reference's; the SSD as it is."""
    load_torchscript_weights(path, module)
    return module if isinstance(module, SSD) else ReferenceLayoutGrid(module)


class ReferenceLayoutGrid(nn.Module):
    """An imported grid model whose reference-convention output
    (``fm[:, x_cell, y_cell]``) is transposed into fdtpu's ``[y, x]``
    layout. Its forward takes the inner model's arguments; ``input_shape``,
    ``grid_size`` and ``compute_dtype`` are the inner model's."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, images: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return self.inner(images, *args, **kwargs).transpose(1, 2).contiguous()

    @property
    def input_shape(self) -> tuple[int, int]:
        return self.inner.input_shape

    @property
    def compute_dtype(self):
        return self.inner.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype) -> None:
        self.inner.compute_dtype = dtype

    def grid_size(self) -> int:
        return self.inner.grid_size()


def pretrained_backbone_variables(path: str | Path, module: MobileNetV3Backbone
                                  ) -> dict[str, torch.Tensor]:
    """A MobileNetV3 ``state_dict`` for training with a pretrained backbone:
    the reference checkpoint's backbone (BatchNorm statistics included)
    under ``module``'s own, freshly drawn ``head`` (the reference's timm
    ``pretrained=True`` with a new 5-channel head). Load it with
    ``module.load_state_dict``."""
    if not isinstance(module, MobileNetV3Backbone):
        raise ValueError(f"a pretrained backbone is MobileNetV3's, not {type(module).__name__}'s")
    sd = _port_state_dict(read_torchscript_state_dict(path), module)
    sd.update({k: v for k, v in module.state_dict().items() if k.startswith("head.")})
    return sd
