"""Detector facade (``fdtpu/models/detector.py``): a model, its decode
thresholds and the serving API.

* :meth:`Detector.apply` — the raw forward on ``(B, H, W, 3)`` float images;
* :meth:`Detector.non_max_suppression` — batched decode+filter+NMS of the raw
  output through the fused kernel (``kernels/nms.py``): the grid tables for
  the grid families, the SSD output tables (pixel scaling) for a family
  whose rows are normalised prior rows (the SSD, RetinaFace: its first five
  columns); for a family with landmarks (RetinaFace) also the kept rows'
  five points, gathered by K1's index of each kept candidate;
* :meth:`Detector.predict` — one image of any size: host-side PIL resize and
  RGB normalisation, ``/255``, forward, decode+filter+NMS, as a
  :class:`Prediction` (with the landmarks, for a family that has them).

On a card ``predict`` and ``non_max_suppression`` replay their device
bodies from CUDA graphs (``utils/graphs.py``), fdtpu's jitted
``_predict_jit`` and ``_nms_batch``: each is captured at its first call
(building a Detector captures nothing), keyed by the input's shape and
dtype, the thresholds rounded to float32 (K1 takes them by value, which a
graph freezes) and the capacity; the :data:`MAX_GRAPHS` most recently used
are kept, in one private memory pool. A lock guards each Detector's graphs,
static inputs and pinned staging buffers, so two threads may share one
Detector, as fdtpu's jitted calls may. A failed capture raises; nothing
falls back to the eager body. On the CPU both run eagerly. ``apply`` is
eager everywhere, as fdtpu's ``apply`` is not jitted. The graphs read the
serving copy's params by address and hold its layers as they were at the
capture: change the params in place.

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
import itertools
import threading

import numpy as np
import torch

from fdtpu_torch.core.nms import decode_filter_nms, ssd_output_filter_nms
from fdtpu_torch.kernels.nms import _f32
from fdtpu_torch.models.layers import BatchNorm
from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.resnet import Resnet
from fdtpu_torch.models.retinaface import RetinaFace
from fdtpu_torch.models.separable import SeparableCNN
from fdtpu_torch.models.ssd import SSD, ssd_patch_sizes
from fdtpu_torch.utils import trace
from fdtpu_torch.utils.config import RetinaFaceConfig
from fdtpu_torch.utils.graphs import Graph, GraphCache, capture_body, clone_outputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("poolresnet", "resnet", "separable", "mobilenetv3", "ssd", "retinaface")
SERVED_ONLY = ("retinaface",)  # families the port serves and does not train or export
MAX_GRAPHS = 8  # the CUDA graphs a Detector keeps


def graph_key(kind: str, shape, dtype: torch.dtype, prob: float, iou: float,
              capacity: int) -> tuple:
    """The key of a :class:`Detector`'s CUDA graph: the program, its input's
    shape and dtype, the thresholds rounded to float32 (K1 takes them by
    value, which a graph freezes: thresholds that round alike share one
    graph, as they give one result) and the capacity."""
    return (kind, tuple(shape), dtype, _f32(prob), _f32(iou), int(capacity))


def is_ssd(module) -> bool:
    return isinstance(module, SSD)


class Prediction(tuple):
    """:meth:`Detector.predict`'s answer. It unpacks as ``(normalized_image
    (H, W, 3), boxes (capacity, 5), mask)``; ``landmarks`` is the kept rows'
    five points ``(capacity, 10)`` ``[x1, y1, ..., x5, y5]`` in pixels,
    zero past the kept rows, for a family with landmarks, and ``None`` for
    the others."""

    def __new__(cls, norm, boxes, mask, landmarks=None):
        out = super().__new__(cls, (norm, boxes, mask))
        out.landmarks = landmarks
        return out


def refuse_served_only(module, what: str) -> None:
    """Raise for a family the port serves and does not ``what`` (train,
    export): RetinaFace has no targets, loss or ``.pt2`` program yet."""
    if isinstance(module, RetinaFace):
        raise NotImplementedError(
            f"RetinaFace is served only: {what} is not ported for it (no landmark "
            "annotations, MultiBox loss or export program yet)")


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
        # the CUDA graphs of predict and non_max_suppression, captured at
        # their first call on a card, least recently used first; one lock
        # for them, their static inputs and the pinned staging buffers
        self._graphs = GraphCache(MAX_GRAPHS)
        self._pool = self._done = None
        self._staging: dict[torch.dtype, tuple] = {}
        self._lock = threading.Lock()
        self._calls = itertools.count()  # predict's calls: its spans' unit

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
        ``(B, S, S, 5)`` float32 grid map, ``(B, N, 5)`` normalized prior
        rows for the SSD, ``(B, N, 15)`` for RetinaFace."""
        return self.net(images)

    def non_max_suppression(self, output: torch.Tensor):
        """Batched decode+filter+NMS over raw model output: ``(boxes, mask)``
        with ``boxes`` ``(B, capacity, 5)`` rows ``[score, x, y, w, h]`` in
        pixels, and for a family with landmarks a third output, their points
        ``(B, capacity, 10)``. On a card a replay of K1 captured for ``output``'s shape
        (fdtpu's jitted ``_nms_batch``)."""
        prob, iou, cap = self.probability_threshold, self.iou_threshold, self.nms_capacity
        if output.device.type != "cuda":
            return self._decode(output, prob, iou, cap)
        key = graph_key("nms", tuple(output.shape), output.dtype, prob, iou, cap)
        with self._lock, torch.cuda.device(output.device):
            with torch.inference_mode(False), torch.no_grad():
                g = self._graph(key, lambda: (output.clone(),),
                                lambda x: self._decode(x, prob, iou, cap))
                g.inputs[0].copy_(output)
                outputs = g.replay()
            return self._release(outputs)

    def _decode(self, output: torch.Tensor, prob: float, iou: float, capacity: int):
        """K1 over the model's output -> ``(boxes, mask)``; for a family
        with landmarks also the kept rows' five points ``(B, capacity, 10)``
        in pixels, zero past the kept rows, gathered by K1's index of each
        kept candidate."""
        if isinstance(self.module, SSD):  # normalised prior rows
            return ssd_output_filter_nms(output, self.image_size, prob, iou, capacity)
        if not isinstance(self.module, RetinaFace):
            return decode_filter_nms(output, self.module.grid_size(), self.image_size, prob,
                                     iou, capacity)
        # RetinaFace: normalised prior rows, then the five points
        boxes, mask, index = ssd_output_filter_nms(output[..., :5].contiguous(), self.image_size,
                                                   prob, iou, capacity, indexed=True)
        w, h = self.image_size
        kept = index.clamp_min(0).long()[..., None].expand(-1, -1, 10)
        xy = torch.gather(output[..., 5:], 1, kept).unflatten(-1, (5, 2))
        points = torch.stack([xy[..., 0] * float(w), xy[..., 1] * float(h)], -1).flatten(-2)
        return boxes, mask, torch.where(index[..., None] >= 0, points, 0.0)

    def predict(
        self,
        image,
        probability_threshold: float | None = None,
        iou_threshold: float | None = None,
    ) -> Prediction:
        """Single-image inference from a raw uint8/float image of any size.

        Returns a :class:`Prediction`: ``(normalized_image (H, W, 3), boxes
        (capacity, 5), mask)`` on the detector's device, and for a family
        with landmarks the kept rows' points as its ``landmarks``;
        :func:`fdtpu_torch.core.compact_boxes` gives the ragged view. The
        host step (:meth:`host_frame`) runs first; on
        the CPU :meth:`predict_body` then runs eagerly, on a card the frame
        goes through a pinned staging buffer into the static input of
        :meth:`predict_body` captured in a CUDA graph, and that graph
        replays (fdtpu's jitted ``_predict_jit``). Traced as
        ``fdtpu/predict`` and its stages (``utils/trace.py``).
        """
        prob = self.probability_threshold if probability_threshold is None else probability_threshold
        iou = self.iou_threshold if iou_threshold is None else iou_threshold
        with trace.span("fdtpu/predict", next(self._calls)), torch.inference_mode():
            with trace.span("fdtpu/predict/host_frame"):
                arr = self.host_frame(image)
            if self.device.type != "cuda":
                outs = self.predict_body(torch.tensor(arr, device=self.device), prob, iou)
                return Prediction(*(o[0] for o in outs))
            with self._lock, torch.cuda.device(self.device):
                with trace.span("fdtpu/predict/stage"):
                    # arr may have negative strides
                    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
                    key = graph_key("predict", arr.shape, dtype, prob, iou, self.nms_capacity)
                    staging = self._staging.get(dtype)
                    if staging is None:
                        staging = self._staging[dtype] = (
                            torch.empty(arr.shape, dtype=dtype, pin_memory=True),
                            torch.cuda.Event())
                    buf, copied = staging
                    copied.synchronize()  # the last copy out of the staging buffer is done
                    buf.numpy()[...] = arr
                    g = self._graph(key, lambda: (buf.to(self.device),),
                                    lambda img: self.predict_body(img, prob, iou))
                    g.inputs[0].copy_(buf, non_blocking=True)
                    copied.record()
                outs = g.replay()
                return Prediction(*self._release(tuple(o[0] for o in outs)))

    def host_frame(self, image) -> np.ndarray:
        """:meth:`predict`'s host step: ``image`` (numpy or a tensor, any
        size) as an ``(H, W, 3)`` array at the model's input size, resized
        and normalised to RGB on the host (PIL, like the reference's host
        resize; RGBA and grayscale become RGB) unless it already has that
        shape."""
        h, w = self.module.input_shape
        if isinstance(image, torch.Tensor):
            image = image.cpu().numpy()
        arr = np.asarray(image)
        if arr.ndim != 3 or arr.shape[-1] != 3 or arr.shape[:2] != (h, w):
            from PIL import Image

            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            arr = np.asarray(Image.fromarray(arr).convert("RGB").resize((w, h), Image.BILINEAR))
        return arr

    def predict_body(self, img: torch.Tensor, prob: float, iou: float):
        """:meth:`predict`'s device body on an ``(H, W, 3)`` frame on the
        device: ``/255``, the forward, decode+filter+NMS (K1). Returns the
        batched ``(norm (1, H, W, 3), boxes (1, capacity, 5), mask)``, and
        for a family with landmarks their points ``(1, capacity, 10)``."""
        norm = img.float()[None] / 255.0
        return (norm, *self._decode(self.net(norm), prob, iou, self.nms_capacity))

    def _release(self, outputs):
        """Clones of a replay's ``outputs``; the next replay, whichever
        stream it goes on, waits for them."""
        with trace.span("fdtpu/predict/release"):
            outputs = clone_outputs(outputs)
            self._done.record()
        return outputs

    def _graph(self, key: tuple, make_inputs, body) -> Graph:
        """The graph of ``key``, captured at its first use from
        ``make_inputs()`` (its static inputs); the least recently used goes
        beyond :data:`MAX_GRAPHS`. Called under the lock."""
        if self._pool is None:
            self._pool, self._done = torch.cuda.graph_pool_handle(), torch.cuda.Event()
        torch.cuda.current_stream().wait_event(self._done)
        return self._graphs.get(key, lambda: capture_body(body, make_inputs(), self._pool))

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
        parent's row. In bfloat16 that forward runs PoolResnet's stem and
        head as one GEMM each (``layers.narrow_conv``, at batch 1), and
        the counter counts the GEMMs: the stem's as its convolution (``K =
        k^2 C``, nothing padded), the head's with its 5 output columns
        padded to 8, so 8/5 of the head's convolution."""
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
    shape (:func:`~fdtpu_torch.models.ssd.ssd_patch_sizes`);
    ``"retinaface"`` takes a ``RetinaFaceConfig`` alone (a family the port
    serves only, :data:`SERVED_ONLY`; ``TypeError`` for another config,
    whose thresholds and capacity are not RetinaFace's); the others take a
    ``DetectorConfig``, each the fields fdtpu's ``build_model`` reads
    (``fast_stem`` is fdtpu's TPU lowering of the same stem and is
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
    elif name == "retinaface":
        if not isinstance(config, RetinaFaceConfig):
            raise TypeError(f"retinaface takes a RetinaFaceConfig, not {type(config).__name__} "
                            "(utils.config.serving_config makes one)")
        module = RetinaFace(config.input_shape, config.in_channels, config.out_channel,
                            config.min_sizes, config.steps, config.variance, config.clip,
                            config.mean, **common)
    else:
        raise ValueError(f"unknown model family: {name}")
    return module.to(device)
