"""Detector facade (``fdtpu/models/detector.py``): a model, its decode
thresholds and the serving API.

* :meth:`Detector.apply` — the raw forward on ``(B, H, W, 3)`` float images;
* :meth:`Detector.non_max_suppression` — batched decode+filter+NMS of the raw
  output through the fused kernel (``kernels/nms.py``): the grid tables for
  PoolResnet, the SSD output tables (pixel scaling) for the SSD;
* :meth:`Detector.predict` — one image of any size: host-side PIL resize and
  RGB normalisation, ``/255``, forward, decode+filter+NMS.

Dtype policy: the module the caller passes is the float32 master copy of
the params. The detector runs a copy of it cast to the compute dtype
(bfloat16 by default, as ``DetectorConfig.dtype``) in channels_last memory
format, made at construction: load the params into the module before
building the Detector. Inputs are cast to the compute dtype inside the
forward and the heads' output is cast to float32 before the sigmoid.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from fdtpu_torch.core.nms import decode_filter_nms, ssd_output_filter_nms
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.ssd import SSD, ssd_patch_sizes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# families of fdtpu's zoo that are not ported yet, with their ROADMAP.md
# queue-1 item
_NOT_PORTED = {"resnet": "item 4", "separable": "item 4", "mobilenetv3": "item 4"}


def is_ssd(module) -> bool:
    return isinstance(module, SSD)


class Detector:
    """A detector module (PoolResnet or SSD) + its decode thresholds."""

    def __init__(
        self,
        module: PoolResnet | SSD,
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


def build_model(
    name: str,
    config,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype | None = None,
) -> PoolResnet | SSD:
    """Construct a float32 detector module by family name, its weights drawn
    from ``generator``, on ``device``: the card unless the caller names
    ``"cpu"`` (no fallback: without a card the default raises).
    ``"poolresnet"`` and ``"ssd"`` are ported; ``"ssd"`` takes an
    ``SSDConfig``, or any config without ``patch_sizes`` (a
    ``DetectorConfig``), whose patch sizes then follow from its input shape
    (:func:`~fdtpu_torch.models.ssd.ssd_patch_sizes`). For serving, the
    compute dtype (``config.dtype``) is the :class:`Detector`'s, see
    :data:`DTYPES`; a module to train takes ``compute_dtype`` and keeps its
    params float32."""
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
            generator=generator,
            compute_dtype=compute_dtype,
        )
        return module.to(device)
    if name == "ssd":
        patch = getattr(config, "patch_sizes", None)
        module = SSD(
            filters=config.filters,
            input_shape=config.input_shape,
            patch_sizes=tuple(patch) if patch else ssd_patch_sizes(config.input_shape),
            generator=generator,
            compute_dtype=compute_dtype,
        )
        return module.to(device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (ROADMAP.md queue 1, {_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown model family: {name}")
