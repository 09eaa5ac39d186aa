"""The fused residual-block tail: the counterpart of
``fdtpu/kernels/epilogue_pallas.py`` (K6).

``maxpool2x2(leaky_relu(c2, 0.2) + skip)`` for the blocks that pool, and
``leaky_relu(c2, 0.2) + skip`` for the others, on ``(N, C, H, W)`` tensors
in channels_last memory (what the models produce) or contiguous NCHW,
float32 or bfloat16. With ``bias`` (one value a channel, the preceding
convolution's bias left out of it) ``c2 + bias`` takes the place of ``c2``,
rounded to the tensors' dtype as PyTorch's separate bias add after a cuDNN
convolution rounds it. It is eval-only, like fdtpu's kernel, which has no
VJP: the wrapper raises when autograd would need a backward.

:func:`fused_residual_tail` dispatches on where the tensors lie: a CPU
tensor runs :func:`reference_tail`, a CUDA tensor launches the hand-written
kernel (``csrc/residual_tail.cu``) or the call raises; ``.launches`` counts
kernel launches. The kernel is bit-equal to :func:`reference_tail`, the op
set the port's ``ResidualBlock`` runs at eval. In bfloat16 that may
differ from fdtpu by one bfloat16 step on negative inputs: PyTorch's leaky
ReLU multiplies by a float32 0.2, fdtpu by 0.2 rounded to bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reference_tail(c2: torch.Tensor, skip: torch.Tensor, pool: bool,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch tail: ``c2 + bias`` (with ``bias``), then
    ``F.leaky_relu(., 0.2) + skip``, then ``F.max_pool2d(., 2)`` with
    ``pool``."""
    if bias is not None:
        c2 = c2 + bias.view(1, -1, 1, 1)
    y = F.leaky_relu(c2, negative_slope=0.2) + skip
    return F.max_pool2d(y, kernel_size=2, stride=2) if pool else y


def _memory_format(c2: torch.Tensor, skip: torch.Tensor) -> torch.memory_format:
    fmt = torch.contiguous_format if c2.is_contiguous() else torch.channels_last
    if not (c2.is_contiguous(memory_format=fmt) and skip.is_contiguous(memory_format=fmt)):
        raise ValueError("c2 and skip must both be contiguous NCHW or both channels_last, got "
                         f"strides {c2.stride()} and {skip.stride()}")
    return fmt


def _check(c2: torch.Tensor, skip: torch.Tensor, pool: bool, bias: torch.Tensor | None) -> None:
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
    grads = c2.requires_grad or skip.requires_grad
    if bias is not None:
        if bias.shape != (c2.shape[1],):
            raise ValueError(f"bias must be ({c2.shape[1]},), got {tuple(bias.shape)}")
        if bias.dtype != c2.dtype:
            raise TypeError(f"bias must be {c2.dtype} like c2, got {bias.dtype}")
        if bias.device != c2.device:
            raise ValueError(f"bias lies on {bias.device}, c2 on {c2.device}")
        grads = grads or bias.requires_grad
    if grads and torch.is_grad_enabled():
        raise RuntimeError("fused_residual_tail is eval-only: it has no backward")


def fused_residual_tail(c2: torch.Tensor, skip: torch.Tensor, *, pool: bool,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """``maxpool2x2(leaky_relu(c2 [+ bias], 0.2) + skip)`` (``pool``) or
    ``leaky_relu(c2 [+ bias], 0.2) + skip`` in one pass; the output keeps
    the inputs' dtype and memory format. One launch on the card."""
    _check(c2, skip, pool, bias)
    fmt = _memory_format(c2, skip)
    if c2.is_cpu:
        return reference_tail(c2, skip, pool, bias)
    if not c2.is_cuda:
        raise ValueError(f"no kernel for device {c2.device}")
    from fdtpu_torch.kernels import build

    # at b1 the eval forward waits on the host, so this path is kept lean:
    # the output comes from empty_like where it can, the stream handle is
    # read directly (as Triton's launcher does), and the current device is
    # switched only when it must be
    n, c, h, w = c2.shape
    if pool:
        out = torch.empty((n, c, h // 2, w // 2), dtype=c2.dtype, device=c2.device,
                          memory_format=fmt)
    else:
        out = torch.empty_like(c2)  # c2 is dense: its strides, fresh storage
    bias_ptr = None
    if bias is not None:
        bias = bias.contiguous()  # held until the launch is queued
        bias_ptr = bias.data_ptr()
    dev = c2.get_device()
    args = (c2.data_ptr(), skip.data_ptr(), out.data_ptr(), bias_ptr,
            int(c2.dtype == torch.bfloat16), n, c, h, w, int(pool),
            int(fmt == torch.channels_last), torch._C._cuda_getCurrentRawStream(dev))
    lib = build.load_library()
    if torch.cuda.current_device() == dev:
        err = lib.fdtpu_residual_tail(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.fdtpu_residual_tail(*args)
    if err != 0:
        raise RuntimeError(f"residual tail kernel launch failed: {build.cuda_error_string(err)}")
    fused_residual_tail.launches += 1
    return out


fused_residual_tail.launches = 0
