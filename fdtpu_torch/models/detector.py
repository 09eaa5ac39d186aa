"""Detector facade (``fdtpu/models/detector.py``): a model, its decode
thresholds and the serving API.

* :meth:`Detector.apply` — the raw forward on ``(B, H, W, 3)`` float images;
* :meth:`Detector.non_max_suppression` — batched decode+filter+NMS of the raw
  output through the fused kernel (``kernels/nms.py``): the grid tables for
  the grid families, the SSD output tables (pixel scaling) for the SSD;
* :meth:`Detector.predict` — one image of any size: host-side PIL resize and
  RGB normalisation, ``/255``, forward, decode+filter+NMS.

Dtype policy: the module the caller passes is the float32 master copy of
the params. The detector runs a copy of it cast to the compute dtype
(bfloat16 by default, as ``DetectorConfig.dtype``) in channels_last memory
format, made at construction: load the params into the module before
building the Detector. Inputs are cast to the compute dtype inside the
forward and the heads' output is cast to float32 before the sigmoid.
BatchNorm layers keep float32 params and statistics in that copy, as Flax
keeps them under ``dtype=bfloat16``, and the copy normalises by the running
statistics (its forward runs with ``train=False``).

* :meth:`Detector.summary` — a per-module table of parameter counts and
  forward FLOPs (``torch.utils.flop_counter``), fdtpu's ``nn.tabulate``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from fdtpu_torch.core.nms import decode_filter_nms, ssd_output_filter_nms
from fdtpu_torch.models.layers import BatchNorm
from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.resnet import Resnet
from fdtpu_torch.models.separable import SeparableCNN
from fdtpu_torch.models.ssd import SSD, ssd_patch_sizes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("poolresnet", "resnet", "separable", "mobilenetv3", "ssd")


def is_ssd(module) -> bool:
    return isinstance(module, SSD)


def has_batch_stats(module: torch.nn.Module) -> bool:
    """Whether ``module`` holds BatchNorm state (fdtpu's ``batch_stats``):
    its forward then takes ``train`` and ``update_stats`` instead of
    dropout masks."""
    return any(isinstance(m, BatchNorm) for m in module.modules())


class Detector:
    """A detector module (any family of the zoo) + its decode thresholds."""

    def __init__(
        self,
        module: torch.nn.Module,
        probability_threshold: float = 0.5,
        iou_threshold: float = 0.5,
        nms_capacity: int = 128,
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.module = module
        self.probability_threshold = probability_threshold
        self.iou_threshold = iou_threshold
        self.nms_capacity = nms_capacity
        self.dtype = dtype
        net = copy.deepcopy(module).eval().requires_grad_(False)
        net.compute_dtype = None  # the copy computes in its own dtype
        self.net = net.to(dtype=dtype, memory_format=torch.channels_last)
        for name, m in self.net.named_modules():
            if isinstance(m, BatchNorm):  # float32 params and statistics, as the master's
                m.float().load_state_dict(module.get_submodule(name).state_dict())

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def image_size(self) -> tuple[int, int]:
        h, w = self.module.input_shape
        return (w, h)

    # -- inference ----------------------------------------------------------

    @torch.inference_mode()
    def apply(self, images: torch.Tensor) -> torch.Tensor:
        """Raw forward on preprocessed ``(B, H, W, 3)`` float images ->
        ``(B, S, S, 5)`` float32 grid map, or ``(B, N, 5)`` normalized prior
        rows for the SSD."""
        return self.net(images)

    def non_max_suppression(self, output: torch.Tensor):
        """Batched decode+filter+NMS over raw model output: ``(boxes, mask)``
        with ``boxes`` ``(B, capacity, 5)`` rows ``[score, x, y, w, h]`` in
        pixels."""
        return self._decode(output, self.probability_threshold, self.iou_threshold)

    def _decode(self, output: torch.Tensor, prob: float, iou: float):
        if is_ssd(self.module):
            return ssd_output_filter_nms(output, self.image_size, prob, iou, self.nms_capacity)
        return decode_filter_nms(output, self.module.grid_size(), self.image_size, prob, iou,
                                 self.nms_capacity)

    @torch.inference_mode()
    def predict(
        self,
        image,
        probability_threshold: float | None = None,
        iou_threshold: float | None = None,
    ):
        """Single-image inference from a raw uint8/float image of any size.

        Returns ``(normalized_image (H, W, 3), boxes (capacity, 5), mask)`` on
        the detector's device; :func:`fdtpu_torch.core.compact_boxes` gives
        the ragged view.
        """
        prob = self.probability_threshold if probability_threshold is None else probability_threshold
        iou = self.iou_threshold if iou_threshold is None else iou_threshold
        h, w = self.module.input_shape
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        arr = np.asarray(image)
        if arr.ndim != 3 or arr.shape[-1] != 3 or arr.shape[:2] != (h, w):
            # resize and normalize to RGB on the host (PIL, like the
            # reference's host resize); RGBA and grayscale become RGB
            from PIL import Image

            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            arr = np.asarray(Image.fromarray(arr).convert("RGB").resize((w, h), Image.BILINEAR))
        img = torch.tensor(arr, device=self.device)
        norm = img.float()[None] / 255.0
        boxes, mask = self._decode(self.net(norm), prob, iou)
        return norm[0], boxes[0], mask[0]

    # -- introspection ------------------------------------------------------

    def summary_rows(self) -> list[tuple[str, str, int, int, int]]:
        """``(name, type, params, buffers, forward FLOPs)`` for the model
        (first, named ``"total"``) and each submodule that its forward
        calls, in module order. Params and buffers are element counts of
        the master module (the buffers are the BatchNorm statistics),
        submodules included; FLOPs (2 per multiply-add of the convolutions
        and matmuls) are ``FlopCounterMode``'s over one forward of the
        serving copy on a zero image. A row counts what the module and the
        modules it calls compute: a layer its parent applies (the port
        applies its convolutions through ``layers.conv``) is counted in the
        parent's row."""
        from torch.utils.flop_counter import FlopCounterMode

        h, w = self.module.input_shape
        counter = FlopCounterMode(display=False)
        with counter, torch.inference_mode():
            self.net(torch.zeros((1, h, w, 3), device=self.device))
        flops = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
        root = type(self.net).__name__
        rows = []
        for name, m in self.module.named_modules():
            key = f"{root}.{name}" if name else root
            if key in flops:
                rows.append((name or "total", type(m).__name__,
                             sum(t.numel() for t in m.parameters()),
                             sum(t.numel() for t in m.buffers()), flops[key]))
        return rows

    def summary(self) -> str:
        """The table of :meth:`summary_rows` as text (fdtpu's ``summary``,
        ``nn.tabulate`` with ``compute_flops``)."""
        h, w = self.module.input_shape
        lines = [f"{type(self.module).__name__} on (1, {h}, {w}, 3)",
                 f"{'module':<20} {'type':<24} {'params':>12} {'buffers':>10} {'FLOPs':>16}"]
        lines += [f"{n:<20} {t:<24} {p:>12,} {b:>10,} {f:>16,}"
                  for n, t, p, b, f in self.summary_rows()]
        return "\n".join(lines)


def build_model(
    name: str,
    config,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.nn.Module:
    """Construct a float32 detector module by family name (:data:`FAMILIES`),
    its weights drawn from ``generator``, on ``device``: the card unless the
    caller names ``"cpu"`` (no fallback: without a card the default raises).
    ``"ssd"`` takes an ``SSDConfig``, or any config without ``patch_sizes``
    (a ``DetectorConfig``), whose patch sizes then follow from its input
    shape (:func:`~fdtpu_torch.models.ssd.ssd_patch_sizes`); the others
    take a ``DetectorConfig``, each the fields fdtpu's ``build_model``
    reads (``fast_stem`` is fdtpu's TPU lowering of the same stem and is
    ignored). For serving, the compute dtype (``config.dtype``) is the
    :class:`Detector`'s, see :data:`DTYPES`; a module to train takes
    ``compute_dtype`` and keeps its params float32."""
    common = dict(generator=generator, compute_dtype=compute_dtype)
    if name == "poolresnet":
        module = PoolResnet(
            filters=config.filters,
            input_shape=config.input_shape,
            num_patches=config.num_patches,
            num_residual_blocks=config.num_residual_blocks,
            input_kernel_size=config.input_kernel_size,
            input_stride=config.input_stride,
            output_kernel_size=config.output_kernel_size,
            output_padding=config.output_padding,
            **common,
        )
    elif name == "resnet":
        module = Resnet(config.filters, config.input_shape, config.num_patches,
                        config.num_residual_blocks, **common)
    elif name == "separable":
        module = SeparableCNN(config.filters, config.input_shape, config.num_patches,
                              config.num_residual_blocks, **common)
    elif name == "mobilenetv3":
        module = MobileNetV3Backbone(config.input_shape, config.num_patches, **common)
    elif name == "ssd":
        patch = getattr(config, "patch_sizes", None)
        module = SSD(
            filters=config.filters,
            input_shape=config.input_shape,
            patch_sizes=tuple(patch) if patch else ssd_patch_sizes(config.input_shape),
            **common,
        )
    else:
        raise ValueError(f"unknown model family: {name}")
    return module.to(device)
