"""Fused decode + confidence filter + greedy NMS: the counterpart of
``fdtpu/kernels/nms_pallas.py``.

One semantics at every batch size, that of fdtpu's batched Pallas kernel
(``_batched_nms_kernel``):

* decode is linear, ``pixel = value * scale + offset`` with per-row tables
  (:func:`grid_decode_tables`, :func:`ssd_output_decode_tables`), then xyxy
  corners rounded half to even;
* a candidate is alive iff ``conf > probability_threshold`` (strict);
* ``capacity`` greedy rounds, each a masked argmax over all candidates (the
  lowest index wins ties), one emitted row ``[score, x, y, w, h]`` and the
  suppression of every candidate with IoU ``> iou_threshold`` against it.
  Rows come out compacted in descending score order; rows after the last
  valid one are zero. There is no top-``capacity`` pre-truncation.

:func:`decode_filter_nms_batch` dispatches on where the tensor lies: a CPU
tensor goes to the plain PyTorch version, :func:`decode_filter_nms_reference`;
a CUDA tensor goes to the hand-written kernel
(``csrc/decode_filter_nms.cu``) or the call raises. The kernel reaches the
same rows by one sort of the eligible candidates and a resolve in chunks of
32 (``tests/test_torch_nms.py`` holds a numpy model of that reformulation
against fdtpu's kernel on the CPU). Thresholds are rounded to
float32 once here, and those values go to either version, as JAX compares a
float32 plane against a weakly typed Python float in float32.

Both versions sit behind one registered op, ``fdtpu_torch::decode_filter_nms``
(:data:`decode_filter_nms_op`), so that ``torch.export`` records K1 as one
node of an exported predict program and a CUDA graph captures its launch.
A second op, ``fdtpu_torch::decode_filter_nms_indexed``
(:data:`decode_filter_nms_indexed_op`), is the same kernel and plain version
returning each kept row's candidate index as well (a family that reads more
of a kept candidate's row than its box, RetinaFace's landmarks).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fdtpu_torch.kernels.launches import LAUNCHES
from fdtpu_torch.utils.device_cache import device_cache

# -- decode tables --------------------------------------------------------------


def grid_decode_tables(num_patches: int, image_size: tuple[int, int]):
    """Per-candidate ``(scale_x, off_x, scale_y, off_y, scale_w, scale_h)`` for
    a row-major-flattened ``(S, S, 5)`` grid map; numpy float32, as
    ``nms_pallas.grid_decode_tables``."""
    width, height = image_size
    s = num_patches
    xp, yp = width / s, height / s
    cols = np.tile(np.arange(s, dtype=np.float32), s)  # x-cell per flat row
    rows = np.repeat(np.arange(s, dtype=np.float32), s)
    n = s * s
    return (
        np.full(n, xp, np.float32), cols * xp,
        np.full(n, yp, np.float32), rows * yp,
        float(width), float(height),
    )


def ssd_decode_tables(patch_sizes: tuple[int, ...], image_size: tuple[int, int]):
    """Tables for raw encoded SSD rows (priors not applied yet):
    ``x_pix = x_enc * (W / ps) + prior_x * W``, as
    ``nms_pallas.ssd_decode_tables``; numpy float32 from the port's
    priors."""
    from fdtpu_torch.core.priors import calculate_priors, prior_scales

    width, height = image_size
    priors = calculate_priors(patch_sizes).numpy()
    scales = prior_scales(patch_sizes).numpy()
    return (
        scales * width, priors[:, 0] * width,
        scales * height, priors[:, 1] * height,
        float(width), float(height),
    )


def ssd_output_decode_tables(num_priors: int, image_size: tuple[int, int]):
    """Tables for SSD model output (priors applied in the graph): pixel
    scaling only, as ``nms_pallas.ssd_output_decode_tables``."""
    width, height = image_size
    n = num_priors
    return (
        np.full(n, width, np.float32), np.zeros(n, np.float32),
        np.full(n, height, np.float32), np.zeros(n, np.float32),
        float(width), float(height),
    )


def _on(tables, device: torch.device):
    *cols, w_scale, h_scale = tables
    with torch.inference_mode(False):
        return (*(torch.from_numpy(c).to(device) for c in cols), w_scale, h_scale)


# The ``*_tables_on`` functions give the tables as float32 tensors on
# ``device``, made once per argument tuple (not while ``torch.export``
# traces, when they would be fake). The tensors are shared by every
# caller and never written; they are made outside inference mode, whoever
# asks first.


@device_cache
def grid_tables_on(num_patches: int, image_size: tuple[int, int], device: torch.device):
    """:func:`grid_decode_tables` on ``device``."""
    return _on(grid_decode_tables(num_patches, image_size), device)


@device_cache
def ssd_tables_on(patch_sizes: tuple[int, ...], image_size: tuple[int, int],
                  device: torch.device):
    """:func:`ssd_decode_tables` on ``device``."""
    return _on(ssd_decode_tables(patch_sizes, image_size), device)


@device_cache
def ssd_output_tables_on(num_priors: int, image_size: tuple[int, int], device: torch.device):
    """:func:`ssd_output_decode_tables` on ``device``."""
    return _on(ssd_output_decode_tables(num_priors, image_size), device)


def _f32(v: float) -> float:
    """A Python float rounded to the nearest float32 value."""
    return float(np.float32(v))


# -- the plain version ------------------------------------------------------------


def decode_filter_nms_reference(
    values: torch.Tensor,
    tables,
    probability_threshold: float,
    iou_threshold: float,
    capacity: int = 128,
    indexed: bool = False,
):
    """Plain batched PyTorch decode+filter+NMS with the kernel's semantics.

    ``values``: ``(B, N, 5)`` float32 rows ``[conf, x, y, w, h]`` as the model
    emits them; ``tables``: ``(sx, ox, sy, oy)`` float32 ``(N,)`` tensors on
    ``values``' device, then ``w_scale, h_scale`` floats. Returns ``boxes``
    ``(B, capacity, 5)`` float32 and ``mask`` ``(B, capacity)`` bool, and
    with ``indexed`` ``index`` ``(B, capacity)`` int32: each kept row's
    candidate, -1 past the kept rows. The scalars are rounded to float32
    first, as the kernel receives them.

    Every step is its own elementwise op (no fused multiply-add), so the
    results are bit-equal to the CUDA kernel's and to fdtpu's kernel in
    interpret mode. It checks for survivors every 8 rounds, like fdtpu's
    ``_greedy_loop``; skipped rounds would only write zero rows.
    """
    sx, ox, sy, oy, w_scale, h_scale = tables
    w_scale, h_scale = _f32(w_scale), _f32(h_scale)
    probability_threshold, iou_threshold = _f32(probability_threshold), _f32(iou_threshold)
    conf = values[..., 0]
    x = values[..., 1] * sx + ox
    y = values[..., 2] * sy + oy
    w = values[..., 3] * w_scale
    h = values[..., 4] * h_scale
    x0, y0, x1, y1 = (torch.round(v) for v in (x, y, x + w, y + h))
    area = (x1 - x0).clamp_min(0.0) * (y1 - y0).clamp_min(0.0)

    b, n = conf.shape
    dev = values.device
    cand = torch.arange(n, device=dev).expand(b, n)
    rows = torch.arange(b, device=dev)
    boxes = torch.zeros((b, capacity, 5), dtype=torch.float32, device=dev)
    mask = torch.zeros((b, capacity), dtype=torch.bool, device=dev)
    index = torch.full((b, capacity), -1, dtype=torch.int32, device=dev)
    alive = conf > probability_threshold
    for k in range(capacity):
        if k % 8 == 0 and not bool(alive.any()):
            break
        sc = torch.where(alive, conf, -1.0)
        best = sc.amax(dim=1)
        valid = best > -0.5
        idx = torch.where(sc == best[:, None], cand, n).amin(dim=1)
        bx0, by0, bx1, by1, barea = (v[rows, idx] for v in (x0, y0, x1, y1, area))
        row = torch.stack([best, bx0, by0, bx1 - bx0, by1 - by0], dim=1)
        boxes[:, k] = torch.where(valid[:, None], row, 0.0)
        mask[:, k] = valid
        index[:, k] = torch.where(valid, idx, -1).to(torch.int32)

        ix0 = torch.maximum(x0, bx0[:, None])
        iy0 = torch.maximum(y0, by0[:, None])
        ix1 = torch.minimum(x1, bx1[:, None])
        iy1 = torch.minimum(y1, by1[:, None])
        inter = (ix1 - ix0).clamp_min(0.0) * (iy1 - iy0).clamp_min(0.0)
        union = area + barea[:, None] - inter
        iou = torch.where(union > 0, inter / union, 0.0)
        alive = alive & (iou <= iou_threshold) & (cand != idx[:, None]) & valid[:, None]
    return (boxes, mask, index) if indexed else (boxes, mask)


# -- the registered op ---------------------------------------------------------------

# ``fdtpu_torch::decode_filter_nms``: K1 as an op that ``torch.export``
# records as one node and a CUDA graph captures. ``values`` ``(B, N, 5)``
# float32, the tables ``(N,)`` float32 on its device, the scalars already
# rounded to float32 (the schema's ``float`` is a double) -> ``boxes``
# ``(B, capacity, 5)`` float32 and ``mask`` ``(B, capacity)`` bool;
# ``fdtpu_torch::decode_filter_nms_indexed`` also -> ``index`` ``(B,
# capacity)`` int32, the same kernel writing it through its index pointer. The
# implementation is chosen by the tensors' device alone: on the CPU the
# plain version, on a card the kernel (:func:`_launch`); any other device
# has none and raises. It is registered with the dispatcher directly
# (``torch.library.Library``), not through ``torch.library.custom_op``,
# whose Python layer in front of the dispatcher costs each call more.
_LIB = torch.library.Library("fdtpu_torch", "DEF")
_LIB.define(
    "decode_filter_nms(Tensor values, Tensor sx, Tensor ox, Tensor sy, Tensor oy, "
    "float w_scale, float h_scale, float prob, float iou, int capacity) -> (Tensor, Tensor)"
)
_LIB.define(
    "decode_filter_nms_indexed(Tensor values, Tensor sx, Tensor ox, Tensor sy, Tensor oy, "
    "float w_scale, float h_scale, float prob, float iou, int capacity) "
    "-> (Tensor, Tensor, Tensor)"
)


def _plain(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity, indexed=False):
    return decode_filter_nms_reference(values, (sx, ox, sy, oy, w_scale, h_scale), prob, iou,
                                       capacity, indexed)


@torch.library.register_fake("fdtpu_torch::decode_filter_nms", lib=_LIB)
def _fake(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity):
    b = values.shape[0]
    return (values.new_empty((b, capacity, 5)),
            values.new_empty((b, capacity), dtype=torch.bool))


@torch.library.register_fake("fdtpu_torch::decode_filter_nms_indexed", lib=_LIB)
def _fake_indexed(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity):
    return (*_fake(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity),
            values.new_empty((values.shape[0], capacity), dtype=torch.int32))


def _launch(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity, indexed=False):
    """The kernel on the card: shared memory up to :func:`max_candidates`
    rows an image, global scratch above (counted apart,
    ``LAUNCHES["decode_filter_nms_scratch"]``); with ``indexed`` the
    kept rows' candidate indices too. Everything goes onto the current
    stream and is allocated by ``torch.empty``, so a CUDA graph captures the
    launch (warm :func:`max_candidates` before capturing)."""
    cols = (sx, ox, sy, oy)
    if not values.is_contiguous() or not all(c.is_contiguous() for c in cols):
        raise ValueError("values and decode tables must be contiguous")
    if not values.get_device() == sx.get_device() == ox.get_device() == sy.get_device() \
            == oy.get_device():
        raise ValueError("the decode tables must lie on the values' card")
    from fdtpu_torch.kernels import build

    lib = build.load_library()
    b, n, _ = values.shape
    dev = values.device.index if values.device.index is not None else torch.cuda.current_device()
    # the kernel writes every row, the zero rows after the last kept one too
    boxes = torch.empty((b, capacity, 5), dtype=torch.float32, device=values.device)
    mask = torch.empty((b, capacity), dtype=torch.bool, device=values.device)
    args = (values.data_ptr(), *(c.data_ptr() for c in cols), w_scale, h_scale, prob, iou,
            b, n, capacity, boxes.data_ptr(), mask.data_ptr())
    index = torch.empty((b, capacity), dtype=torch.int32, device=values.device) \
        if indexed else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = None
        if n > max_candidates(dev):
            scratch = torch.empty((b, lib.fdtpu_decode_filter_nms_scratch_floats(n)),
                                  dtype=torch.float32, device=values.device)
        if indexed:
            err = lib.fdtpu_decode_filter_nms_indexed(
                *args, index.data_ptr(), None if scratch is None else scratch.data_ptr(), stream)
        elif scratch is None:
            err = lib.fdtpu_decode_filter_nms(*args, stream)
        else:
            err = lib.fdtpu_decode_filter_nms_scratch(*args, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_filter_nms kernel launch failed: {build.cuda_error_string(err)}"
        )
    LAUNCHES["decode_filter_nms"] += 1
    if scratch is not None:
        LAUNCHES["decode_filter_nms_scratch"] += 1
    return (boxes, mask, index) if indexed else (boxes, mask)


def _plain_indexed(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity):
    return _plain(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity, True)


def _launch_indexed(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity):
    return _launch(values, sx, ox, sy, oy, w_scale, h_scale, prob, iou, capacity, True)


_LIB.impl("decode_filter_nms", _plain, "CPU")
_LIB.impl("decode_filter_nms", _launch, "CUDA")
_LIB.impl("decode_filter_nms_indexed", _plain_indexed, "CPU")
_LIB.impl("decode_filter_nms_indexed", _launch_indexed, "CUDA")
decode_filter_nms_op = torch.ops.fdtpu_torch.decode_filter_nms.default
decode_filter_nms_indexed_op = torch.ops.fdtpu_torch.decode_filter_nms_indexed.default


# -- the dispatching wrapper --------------------------------------------------------


def decode_filter_nms_batch(
    values: torch.Tensor,
    tables,
    probability_threshold: float,
    iou_threshold: float,
    capacity: int = 128,
    indexed: bool = False,
):
    """Batched fused decode+filter+NMS; the counterpart of
    ``pallas_decode_filter_nms_batch`` (and, at ``B = 1``, of
    ``pallas_decode_filter_nms``).

    ``values``: ``(B, N, 5)`` float32; ``tables``: from one of the
    ``*_decode_tables`` functions (numpy) or :func:`grid_tables_on` (tensors).
    Returns ``(boxes (B, capacity, 5) [score, x, y, w, h] pixels, mask)``,
    and with ``indexed`` also ``index (B, capacity)`` int32, each kept row's
    candidate, -1 past the kept rows (``fdtpu_torch::decode_filter_nms_indexed``).

    It checks the arguments and calls ``fdtpu_torch::decode_filter_nms``
    (:data:`decode_filter_nms_op`) where a tracer would see the call
    (:func:`_traced`); in plain eager code it calls the op's implementation
    for the device itself, which spares each call the dispatcher's round
    trip through Python. A CPU tensor runs the plain version. A
    CUDA tensor launches the kernel, and ``LAUNCHES["decode_filter_nms"]``
    counts each launch (``kernels/launches.py``); anything the kernel does
    not take raises.
    Up to :func:`max_candidates` rows an image the kernel keeps its working
    set in shared memory; above that the same kernel works in a scratch
    tensor, ``B`` times the planes and the sort list of the padded ``N``,
    and ``LAUNCHES["decode_filter_nms_scratch"]`` counts the launch too.
    """
    if values.dim() != 3 or values.shape[-1] != 5:
        raise ValueError(f"values must be (B, N, 5), got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    b, n, _ = values.shape
    if b < 1 or n < 1 or capacity < 1:
        raise ValueError(f"empty problem: B={b}, N={n}, capacity={capacity}")
    device = values.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    sx, ox, sy, oy, w_scale, h_scale = tables
    cols = tuple(torch.as_tensor(t, dtype=torch.float32, device=device) for t in (sx, ox, sy, oy))
    if any(c.shape != (n,) for c in cols):
        raise ValueError(f"decode tables must each be ({n},)")
    scalars = tuple(_f32(v) for v in (w_scale, h_scale, probability_threshold, iou_threshold))
    if _traced(values):
        op = decode_filter_nms_indexed_op if indexed else decode_filter_nms_op
        return op(values, *cols, *scalars, capacity)
    impl = _launch if device.type == "cuda" else _plain
    return impl(values, *cols, *scalars, capacity, indexed)


def _traced(values: torch.Tensor) -> bool:
    """Whether anything but plain eager code sees this call: a tensor
    subclass (the fake tensors of ``torch.export``), a dispatch or function
    mode, or ``torch.compile``. Then only the op, one node, may stand for
    K1."""
    return (type(values) is not torch.Tensor or torch.compiler.is_compiling()
            or torch._C._len_torch_dispatch_stack() > 0
            or torch._C._is_torch_function_mode_enabled())


@functools.lru_cache(maxsize=None)
def max_candidates(device_index: int) -> int:
    """The most candidates whose planes and sort list fit one CTA's shared
    memory on the card ``device_index``: up to it the kernel works in shared
    memory, above it in global scratch."""
    from fdtpu_torch.kernels import build

    out = ctypes.c_int(0)
    err = build.load_library().fdtpu_decode_filter_nms_max_candidates(
        device_index, ctypes.byref(out)
    )
    if err != 0:
        raise RuntimeError(f"querying the card failed: {build.cuda_error_string(err)}")
    return out.value
