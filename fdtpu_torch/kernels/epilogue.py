"""The fused residual-block tail: the counterpart of
``fdtpu/kernels/epilogue_pallas.py`` (K6).

``maxpool2x2(leaky_relu(c2, 0.2) + skip)`` for the blocks that pool, and
``leaky_relu(c2, 0.2) + skip`` for the others, on ``(N, C, H, W)`` tensors
in channels_last memory (what the models produce) or contiguous NCHW,
float32 or bfloat16. It is eval-only, like fdtpu's kernel, which has no
VJP: the wrapper raises when autograd would need a backward.

:func:`fused_residual_tail` dispatches on where the tensors lie: a CPU
tensor runs :func:`reference_tail`, a CUDA tensor launches the hand-written
kernel (``csrc/residual_tail.cu``) or the call raises; ``.launches`` counts
kernel launches. The kernel is bit-equal to :func:`reference_tail`, the op
set the port's ``ResidualBlock`` runs at eval. In bfloat16 that may differ
from fdtpu by one bfloat16 step on negative inputs: PyTorch's leaky ReLU
multiplies by a float32 0.2, fdtpu by 0.2 rounded to bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reference_tail(c2: torch.Tensor, skip: torch.Tensor, pool: bool) -> torch.Tensor:
    """Plain PyTorch tail: ``F.leaky_relu(c2, 0.2) + skip``, then
    ``F.max_pool2d(., 2)`` with ``pool``."""
    y = F.leaky_relu(c2, negative_slope=0.2) + skip
    return F.max_pool2d(y, kernel_size=2, stride=2) if pool else y


def _memory_format(c2: torch.Tensor, skip: torch.Tensor) -> torch.memory_format:
    fmt = torch.contiguous_format if c2.is_contiguous() else torch.channels_last
    if not (c2.is_contiguous(memory_format=fmt) and skip.is_contiguous(memory_format=fmt)):
        raise ValueError("c2 and skip must both be contiguous NCHW or both channels_last, got "
                         f"strides {c2.stride()} and {skip.stride()}")
    return fmt


def _check(c2: torch.Tensor, skip: torch.Tensor, pool: bool) -> None:
    if c2.dim() != 4 or c2.shape != skip.shape:
        raise ValueError(f"c2 and skip must be one (N, C, H, W) shape, got {tuple(c2.shape)} "
                         f"and {tuple(skip.shape)}")
    if c2.dtype != skip.dtype or c2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c2 and skip must both be float32 or bfloat16, got {c2.dtype} "
                        f"and {skip.dtype}")
    if c2.device != skip.device:
        raise ValueError(f"c2 and skip lie on {c2.device} and {skip.device}")
    if pool and (c2.shape[2] % 2 or c2.shape[3] % 2):
        raise ValueError(f"pooling takes an even height and width, got {tuple(c2.shape[2:])}")
    if c2.numel() >= 2**31:
        raise ValueError("c2 too large for 32-bit element indices")
    if torch.is_grad_enabled() and (c2.requires_grad or skip.requires_grad):
        raise RuntimeError("fused_residual_tail is eval-only: it has no backward")


def fused_residual_tail(c2: torch.Tensor, skip: torch.Tensor, *, pool: bool) -> torch.Tensor:
    """``maxpool2x2(leaky_relu(c2, 0.2) + skip)`` (``pool``) or
    ``leaky_relu(c2, 0.2) + skip`` in one pass; the output keeps the
    inputs' dtype and memory format. One launch on the card."""
    _check(c2, skip, pool)
    fmt = _memory_format(c2, skip)
    if c2.device.type == "cpu":
        return reference_tail(c2, skip, pool)
    if c2.device.type != "cuda":
        raise ValueError(f"no kernel for device {c2.device}")
    from fdtpu_torch.kernels import build

    n, c, h, w = c2.shape
    shape = (n, c, h // 2, w // 2) if pool else (n, c, h, w)
    out = torch.empty(shape, dtype=c2.dtype, device=c2.device, memory_format=fmt)
    lib = build.load_library()
    dev = c2.device.index if c2.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.fdtpu_residual_tail(
            c2.data_ptr(), skip.data_ptr(), out.data_ptr(), int(c2.dtype == torch.bfloat16),
            n, c, h, w, int(pool), int(fmt == torch.channels_last),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"residual tail kernel launch failed: {build.cuda_error_string(err)}")
    fused_residual_tail.launches += 1
    return out


fused_residual_tail.launches = 0
