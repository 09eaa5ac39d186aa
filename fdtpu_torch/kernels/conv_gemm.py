"""A convolution as one GEMM: the windows of the input gathered into a
matrix (im2col: ``Tensor.unfold`` views and one copy) and multiplied by the
weight in one ``torch.addmm``, the bias added in the GEMM's epilogue.

Not a hand-written kernel: library calls (cuBLAS on a card, oneDNN on the
CPU) in the input's dtype, accumulating in float32. It serves where cuDNN's
own choice for a convolution is slow: on an H100 in bfloat16 at batch 1,
cuDNN ran PoolResnet's 3-channel k10/s8 stem behind a padding pass of its
own (0.052 ms; this form 0.019 ms), and its 5-channel k6 head off the tensor
cores as ``precomputed_convolve_sgemm`` (0.42 ms; this form 0.02-0.04 ms).
The rule that picks this form is ``models/layers.narrow_conv``.

``LAUNCHES["conv_gemm"]`` counts calls (one GEMM each), as the
hand-written kernels' wrappers count theirs (``kernels/launches.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.kernels.launches import LAUNCHES


def conv_gemm(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied to ``x`` ``(B, C, H, W)`` (any memory format) in
    ``x``'s dtype: the convolution of :func:`~fdtpu_torch.models.layers.conv`
    as one GEMM of ``(B Ho Wo, kh kw C)`` windows, in ``(kh, kw, C)`` order,
    by the weight seen as ``(kh kw C, Cout)``. The weight's columns are
    zero-padded to a multiple of 8 (16-byte rows of the output, which cuBLAS's
    tensor-core kernels want); the added columns are sliced off. Returns
    ``(B, Cout, Ho, Wo)`` in channels_last memory format, as cuDNN gives it.
    The weight is read and reshaped here, in the forward, so that a CUDA
    graph that captured the call reads the params by address."""
    if layer.groups != 1 or layer.dilation != (1, 1) or isinstance(layer.padding, str):
        raise ValueError(f"conv_gemm takes a dense, undilated, numerically padded layer, "
                         f"got {layer}")
    (kh, kw), (sh, sw), (ph, pw) = layer.kernel_size, layer.stride, layer.padding
    b, c = x.shape[:2]
    cout = layer.out_channels
    cols_out = -(-cout // 8) * 8
    xh = x.permute(0, 2, 3, 1)
    if ph or pw:
        xh = F.pad(xh, (0, 0, pw, pw, ph, ph))
    # (B, Ho, Wo, C, kh, kw) windows: views that read the strides at run
    # time (``as_strided`` would bake them into an exported program)
    windows = xh.unfold(1, kh, sh).unfold(2, kw, sw)
    ho, wo = windows.shape[1:3]
    cols = windows.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kw * c)
    weight = layer.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(cout, kh * kw * c)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    if cols_out != cout:
        weight = F.pad(weight, (0, 0, 0, cols_out - cout))
        bias = None if bias is None else F.pad(bias, (0, cols_out - cout))
    out = cols @ weight.t() if bias is None else torch.addmm(bias, cols, weight.t())
    LAUNCHES["conv_gemm"] += 1
    return out.view(b, ho, wo, cols_out).permute(0, 3, 1, 2)[:, :cout]

