"""Write the port's models as ``.fdn`` artifacts for the native engine
(fdtpu's ``export/native_format.py``, format ``FDN1`` v2).

The ``.fdn`` file is a flat op program plus a float32 weight blob that the
C++ engine (``fdtpu_torch/native/infer_engine.cpp``) runs with no Python ML
framework present: the counterpart of the reference's TorchScript
lite-interpreter and onnxruntime artifacts. The bytes are fdtpu's for the
same weights: the port's OIHW kernels are turned into fdtpu's HWIO arrays
first, and every fold and quantization runs in numpy float32 in fdtpu's
order.

Format ``FDN1`` (little-endian):

    u32 magic 'FDN1' | u32 version | u32 n_ops
    u32 in_h | u32 in_w | u32 grid_s | u32 capacity
    f32 prob_thr | f32 iou_thr | u64 blob_bytes
    n_ops x op records (48 bytes):
        u32 code | i32 p0..p5 | f32 f0 | u64 woff | u64 boff
    f32 weight blob

Op codes: CONV=1 (p: k, stride, pad, cin, cout, groups; pad == -1 means
TF-style SAME, asymmetric with more at the end; weights HWIO reshaped to
``(k*k*cin_per_group, cout)`` row-major, the engine's im2col order;
boff == 2^64-1 means no bias), LEAKY=2 (f0 slope), MAXPOOL2=3, SIGMOID=4,
PUSH=5 (save the skip), ADDSKIP=6 (x += saved), DECODE_NMS=7 (grid decode,
confidence filter and greedy NMS with the header's thresholds),
TRANSPOSE_GRID=8, RELU=9, HARDSWISH=10, SE=11 (p: channels, reduced; woff
-> packed ``[w1 (C,R), b1 (R), w2 (R,C), b2 (C)]``), SSD_HEAD=12 (p: cin,
prior_offset, n_pix; a position-wise ``Linear(cin -> 5)`` into the prior
buffer, sigmoid on the score), SSD_DECODE_NMS=13 (p: n_scales, ps...),
PUSH_PROJ=14 (skip = conv1x1(x), the SSD block's projection; CONV's params
with k=1), CONV_Q8=15 (CONV with int8 weights: woff -> ``[scales f32
(cout), wsum f32 (cout), int8 weights packed (ceil(K/4), cout, 4)]``;
activations quantized per row to 8 bits at run time).

BatchNorm (MobileNetV3) is folded into the conv before it from the running
statistics: the kernel scaled by ``g / sqrt(var + eps)`` per output channel,
the bias ``b - mu * g / sqrt(var + eps)``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch
from torch import nn

from fdtpu_torch.models.mobilenetv3 import MOBILENETV3_SMALL, MobileNetV3Backbone, make_divisible
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.ssd import SSD

MAGIC = int.from_bytes(b"FDN1", "little")
VERSION = 2  # v2: the MobileNetV3 and SSD ops (9-14) and SAME padding
NO_BIAS = (1 << 64) - 1

OP_CONV = 1
OP_LEAKY = 2
OP_MAXPOOL2 = 3
OP_SIGMOID = 4
OP_PUSH = 5
OP_ADDSKIP = 6
OP_DECODE_NMS = 7
OP_TRANSPOSE_GRID = 8  # swap the (S, S) axes of the final (S, S, 5) map
OP_RELU = 9
OP_HARDSWISH = 10
OP_SE = 11
OP_SSD_HEAD = 12
OP_SSD_DECODE_NMS = 13
OP_PUSH_PROJ = 14
OP_CONV_Q8 = 15  # int8-weight conv (dynamic u8 activation quantization)

SAME_PAD = -1  # TF-style SAME padding sentinel in the conv pad slot

_LEAKY_SLOPE = 0.2  # the reference's LeakyReLU slope


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def conv_params(layer: nn.Conv2d) -> dict:
    """A conv's weights as fdtpu keeps them: ``kernel`` HWIO (a depthwise
    kernel ``(k, k, 1, C)``), ``bias`` when the layer has one."""
    params = {"kernel": np.ascontiguousarray(_np(layer.weight).transpose(2, 3, 1, 0))}
    if layer.bias is not None:
        params["bias"] = _np(layer.bias)
    return params


def _fold_bn(conv: dict, bn) -> dict:
    """Fold an inference-mode BatchNorm (``layers.BatchNorm``) into the
    conv before it, fdtpu's formula in fdtpu's order: ``inv = g /
    sqrt(var + eps)``, kernel ``* inv``, bias ``beta - mu * inv`` (plus the
    scaled conv bias when there is one)."""
    g, beta = _np(bn.weight), _np(bn.bias)
    mu, var = _np(bn.running_mean), _np(bn.running_var)
    inv = g / np.sqrt(var + bn.eps)
    kernel = conv["kernel"] * inv
    bias = beta - mu * inv
    if "bias" in conv:
        bias = bias + conv["bias"] * inv
    return {"kernel": kernel, "bias": bias}


class _ProgramWriter:
    def __init__(self, weight_quant: str | None = None):
        self.ops: list[tuple] = []
        self.blob = bytearray()
        self.weight_quant = weight_quant

    def _put(self, arr: np.ndarray) -> int:
        off = len(self.blob)
        self.blob += np.ascontiguousarray(arr, dtype=np.float32).tobytes()
        return off

    def _put_bytes(self, raw: bytes) -> int:
        off = len(self.blob)
        assert len(raw) % 4 == 0
        self.blob += raw
        return off

    def conv(self, params: dict, k: int, stride: int, pad: int, groups: int = 1,
             code: int = OP_CONV):
        kernel = np.asarray(params["kernel"], np.float32)  # HWIO
        kh, kw, cin_g, cout = kernel.shape
        assert kh == k and kw == k, (kernel.shape, k)
        cin = cin_g * groups
        K = k * k * cin_g
        # int8 weights for dense convs only, not the tiny stem (K < 64) nor
        # the 5-channel head (cout < 8); per-cout symmetric 7-bit scales
        # (7-bit weights keep the engine's u8 x s8 pair sums below i16
        # saturation, 255 * 63 * 2 < 2^15); 4 K-values a channel dword
        if (self.weight_quant == "int8" and code == OP_CONV and groups == 1
                and cout >= 8 and K >= 64):
            wm = kernel.reshape(K, cout)
            scales = np.max(np.abs(wm), axis=0) / 63.0
            scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
            wq = np.clip(np.rint(wm / scales), -63, 63).astype(np.int8)
            wsum = wq.astype(np.int32).sum(axis=0).astype(np.float32)
            K4 = (K + 3) // 4 * 4
            packed = np.pad(wq, ((0, K4 - K), (0, 0))).reshape(
                K4 // 4, 4, cout).transpose(0, 2, 1)  # (group, cout, 4)
            woff = self._put(scales)
            self._put(wsum)
            self._put_bytes(packed.tobytes())
            boff = (self._put(np.asarray(params["bias"], np.float32))
                    if "bias" in params else NO_BIAS)
            self.ops.append((OP_CONV_Q8, k, stride, pad, cin, cout, groups, 0.0, woff, boff))
            return
        woff = self._put(kernel.reshape(-1, cout))
        boff = self._put(np.asarray(params["bias"], np.float32)) if "bias" in params else NO_BIAS
        self.ops.append((code, k, stride, pad, cin, cout, groups, 0.0, woff, boff))

    def se(self, se, channels: int, reduced: int):
        """The squeeze-excite gate: ``[w1 (C,R), b1 (R), w2 (R,C), b2 (C)]``."""
        w1 = conv_params(se.reduce)["kernel"]
        w2 = conv_params(se.expand)["kernel"]
        assert w1.shape == (1, 1, channels, reduced), w1.shape
        assert w2.shape == (1, 1, reduced, channels), w2.shape
        packed = np.concatenate([
            w1.reshape(-1), _np(se.reduce.bias).reshape(-1),
            w2.reshape(-1), _np(se.expand.bias).reshape(-1),
        ])
        woff = self._put(packed)
        self.ops.append((OP_SE, channels, reduced, 0, 0, 0, 0, 0.0, woff, NO_BIAS))

    def ssd_head(self, head: nn.Linear, cin: int, prior_offset: int, n_pix: int):
        """The position-wise ``Linear(cin -> 5)`` head into the prior buffer:
        kernel ``(cin, 5)`` row-major, bias ``(5,)``."""
        kernel = np.ascontiguousarray(_np(head.weight).T)
        assert kernel.shape == (cin, 5), kernel.shape
        woff = self._put(kernel)
        boff = self._put(_np(head.bias))
        self.ops.append((OP_SSD_HEAD, cin, prior_offset, n_pix, 0, 0, 0, 0.0, woff, boff))

    def simple(self, code: int, f0: float = 0.0, p: tuple = ()):
        p = tuple(p) + (0,) * (6 - len(p))
        self.ops.append((code, *p, f0, NO_BIAS, NO_BIAS))

    def serialize(self, in_h: int, in_w: int, grid_s: int, capacity: int,
                  prob_thr: float, iou_thr: float) -> bytes:
        head = struct.pack("<7I2fQ", MAGIC, VERSION, len(self.ops), in_h, in_w, grid_s,
                           capacity, prob_thr, iou_thr, len(self.blob))
        recs = b"".join(struct.pack("<I6ifQQ", *op) for op in self.ops)
        return head + recs + bytes(self.blob)


def _grid_program(model: PoolResnet, transpose_grid: bool, weight_quant=None) -> tuple[_ProgramWriter, int]:
    """The ops of a grid detector (PoolResnet, Resnet, SeparableCNN: one
    body, ``models/poolresnet.py``) with dropout elided and the pooling
    resolved as ``grid_size()`` resolves it."""
    from fdtpu_torch.models.layers import SeparableResidualBlock

    b = _ProgramWriter(weight_quant)
    k, stride = model.input_kernel_size, model.input_stride
    pad = k - stride
    b.conv(conv_params(model.conv1), k=k, stride=stride, pad=pad)
    dim = (model.input_shape[0] + 2 * pad - k) // stride + 1
    pool_until = model.POOL_FACTOR * model.num_patches
    for block in model.residual_blocks:
        b.simple(OP_PUSH)
        if isinstance(block, SeparableResidualBlock):
            b.conv(conv_params(block.pointwise_conv1), k=1, stride=1, pad=0)
            b.simple(OP_LEAKY, _LEAKY_SLOPE)
            b.conv(conv_params(block.depthwise_conv), k=3, stride=1, pad=1,
                   groups=block.depthwise_conv.groups)
            b.simple(OP_LEAKY, _LEAKY_SLOPE)
            b.conv(conv_params(block.pointwise_conv2), k=1, stride=1, pad=0)
        else:
            b.conv(conv_params(block.conv1), k=3, stride=1, pad=1)
            b.simple(OP_LEAKY, _LEAKY_SLOPE)
            b.conv(conv_params(block.conv2), k=3, stride=1, pad=1)
            b.simple(OP_LEAKY, _LEAKY_SLOPE)
        b.simple(OP_ADDSKIP)
        if dim > pool_until:
            b.simple(OP_MAXPOOL2)
            dim //= 2
    out_k, out_pad = model.output_kernel_size, model.output_padding
    b.conv(conv_params(model.out), k=out_k, stride=1, pad=out_pad)
    b.simple(OP_SIGMOID)
    if transpose_grid:
        b.simple(OP_TRANSPOSE_GRID)
    b.simple(OP_DECODE_NMS)
    grid = dim + 2 * out_pad - out_k + 1
    assert grid == model.grid_size(), (grid, model.grid_size())
    if grid <= 0:
        raise ValueError(f"invalid geometry: head conv k={out_k} on a {dim}x{dim} map gives "
                         f"grid {grid}; the model itself cannot run this config")
    return b, grid


def _mobilenetv3_program(model: MobileNetV3Backbone, transpose_grid: bool,
                         weight_quant=None) -> tuple[_ProgramWriter, int]:
    """MobileNetV3-Small's ops (``models/mobilenetv3.py``): each BatchNorm
    folded into its conv, SE gates as OP_SE, hard-swish or ReLU, residual
    adds where the stride is 1 and the channels match, SAME pads on the
    stem and the depthwise convs."""
    b = _ProgramWriter(weight_quant)

    def fconv(layer, bn, **kw):
        b.conv(_fold_bn(conv_params(layer), bn), **kw)

    fconv(model.conv_stem, model.bn1, k=3, stride=2, pad=SAME_PAD)
    b.simple(OP_HARDSWISH)
    in_ch = 16
    for block, (k, exp, out, se, act, s) in zip(model.blocks, MOBILENETV3_SMALL):
        act_op = OP_RELU if act == "relu" else OP_HARDSWISH
        residual = s == 1 and in_ch == out
        if residual:
            b.simple(OP_PUSH)
        if exp != in_ch:
            fconv(block.conv_pw, block.bn1, k=1, stride=1, pad=0)
            b.simple(act_op)
        fconv(block.conv_dw, block.bn2, k=k, stride=s, pad=SAME_PAD, groups=exp)
        b.simple(act_op)
        if se:
            b.se(block.se, exp, make_divisible(exp * 0.25))
        fconv(block.conv_pwl, block.bn3, k=1, stride=1, pad=0)
        if residual:
            b.simple(OP_ADDSKIP)
        in_ch = out
    fconv(model.conv_576, model.bn_576, k=1, stride=1, pad=0)
    b.simple(OP_HARDSWISH)
    # the detection head pads 1 explicitly
    b.conv(conv_params(model.head), k=model.head.kernel_size[0], stride=1,
           pad=model.head.padding[0])
    b.simple(OP_SIGMOID)
    if transpose_grid:
        b.simple(OP_TRANSPOSE_GRID)
    b.simple(OP_DECODE_NMS)
    return b, model.grid_size()


def _ssd_program(model: SSD, weight_quant=None) -> _ProgramWriter:
    """The SSD's ops (``models/ssd.py``): the stem, 9 extractor blocks and
    one block a scale, each scale's head written into the prior buffer,
    the prior decode and NMS at the end. Dropout elided."""
    b = _ProgramWriter(weight_quant)

    def block(blk):
        if blk.skip is None:
            b.simple(OP_PUSH)
        else:  # the 1x1 skip projection
            b.conv(conv_params(blk.skip), k=1, stride=1, pad=0, code=OP_PUSH_PROJ)
        b.conv(conv_params(blk.conv1), k=3, stride=1, pad=1)
        b.simple(OP_LEAKY, _LEAKY_SLOPE)
        b.conv(conv_params(blk.conv2), k=3, stride=1, pad=1)
        b.simple(OP_LEAKY, _LEAKY_SLOPE)
        b.simple(OP_ADDSKIP)
        if blk.use_max_pool:
            b.simple(OP_MAXPOOL2)

    b.conv(conv_params(model.stem), k=3, stride=2, pad=1)
    for blk in model.extractor:
        block(blk)
    prior_off = 0
    for ps, blk, head in zip(model.patch_sizes, model.scales, model.heads):
        block(blk)
        b.ssd_head(head, head.in_features, prior_off, ps * ps)
        prior_off += ps * ps
    b.simple(OP_SSD_DECODE_NMS, p=(len(model.patch_sizes), *model.patch_sizes))
    return b


def export_native(
    model: nn.Module,
    path: str | Path,
    probability_threshold: float = 0.7,
    iou_threshold: float = 0.01,
    capacity: int = 64,
    weight_quant: str | None = None,
) -> Path:
    """Write ``model`` (any family of the zoo, or a grid model in
    ``ReferenceLayoutGrid``) to the ``.fdn`` artifact ``path`` for the
    native engine (``fdtpu_torch.native``).

    Thresholds default to the reference converter's. Weights are stored
    float32 whatever the model computes in; BatchNorm is folded, so the
    artifact is inference-only. ``weight_quant="int8"`` stores the dense
    convs' weights as per-output-channel symmetric int8 (about 4x smaller);
    the engine then quantizes activations per conv at run time."""
    from fdtpu_torch.compat.torch_import import ReferenceLayoutGrid

    # a reference checkpoint's grid is spatially transposed: the wrapper's
    # swap becomes an OP_TRANSPOSE_GRID before the decode
    transpose_grid = isinstance(model, ReferenceLayoutGrid)
    if transpose_grid:
        model = model.inner
    if isinstance(model, SSD):
        b, grid = _ssd_program(model, weight_quant), 0  # grid_s == 0 marks an SSD artifact
    elif isinstance(model, MobileNetV3Backbone):
        b, grid = _mobilenetv3_program(model, transpose_grid, weight_quant)
    elif isinstance(model, PoolResnet):
        b, grid = _grid_program(model, transpose_grid, weight_quant)
    else:
        raise ValueError(f"no .fdn program for {type(model).__name__}")
    h, w = model.input_shape
    data = b.serialize(h, w, grid, capacity, probability_threshold, iou_threshold)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path
