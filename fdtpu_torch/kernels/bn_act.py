"""BatchNorm at eval, the residual add and the activation in one pass
(``csrc/bn_act.cu``): a kernel of the port alone, with no TPU counterpart
(fdtpu's XLA fused these ops into the convolution around them).

``act(bn(y) [+ skip])`` on ``(N, C, H, W)`` tensors in channels_last
memory, float32 or bfloat16, where ``bn`` normalises by the running
statistics (``F.batch_norm`` with ``training=False``) and ``act`` is
``None`` (none), ``0.0`` (``F.relu``) or a slope (``F.leaky_relu``), as
``models/layers.bn_act`` takes it. The BatchNorm's ``weight``,
``bias``, ``running_mean`` and ``running_var`` are float32 ``(C,)``
tensors, read by the kernel on every launch: a CUDA graph that captured
the launch reads them by address, so a change to them in place reaches the
graph. The output is a fresh tensor of ``y``'s shape, dtype and memory
format.

:func:`fused_bn_act` dispatches on where the tensors lie: a CPU tensor runs
:func:`reference_bn_act`, a CUDA tensor launches the kernel or the call
raises; ``LAUNCHES["bn_act"]`` counts kernel launches
(``kernels/launches.py``). The kernel computes ATen's own BatchNorm formula
(``batch_norm_transform_input_channels_last_kernel``): each eager op
computes in float32 and rounds its result to the tensors' dtype, and the
kernel rounds at the same points. So it is bit-equal to
:func:`reference_bn_act` on the card in bfloat16, where PyTorch runs
ATen's kernel; in float32 PyTorch picks cuDNN's BatchNorm, whose roundings
differ by an ulp here and there, and the kernel is bit-equal to the chain
with cuDNN off. It is eval-only: the wrapper raises when autograd would
need a backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fdtpu_torch.kernels.launches import LAUNCHES


def reference_bn_act(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                     act: float | None = None, skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch chain: ``F.batch_norm`` by the running statistics,
    ``+ skip`` (with ``skip``), then the activation."""
    x = F.batch_norm(y, running_mean, running_var, weight, bias, False, 0.0, eps)
    if skip is not None:
        x = x + skip
    if act is None:
        return x
    return F.leaky_relu(x, act) if act else F.relu(x)


def _check(y, params, skip, act) -> None:
    """Raises on the operands the kernel does not take."""
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"y must be dense channels_last, got strides {y.stride()}")
    if skip is not None:
        if skip.shape != y.shape or skip.dtype != y.dtype or skip.device != y.device:
            raise ValueError(f"skip must be {tuple(y.shape)} {y.dtype} on {y.device} like y, "
                             f"got {tuple(skip.shape)} {skip.dtype} on {skip.device}")
        if not skip.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"skip must be dense channels_last, got strides {skip.stride()}")
    c = y.shape[1]
    for name, p in zip(("weight", "bias", "running_mean", "running_var"), params):
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != y.device or p.stride(0) != 1:
            raise ValueError(f"{name} must be a dense ({c},) float32 tensor on {y.device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    if act is not None and not (isinstance(act, float) and act >= 0.0):
        raise ValueError(f"act must be None, 0.0 (ReLU) or a LeakyReLU slope > 0, got {act!r}")
    if y.numel() >= 2**31:
        raise ValueError("y too large for 32-bit row indices")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (y, skip, *params)):
        raise RuntimeError("fused_bn_act is eval-only: it has no backward")


def fused_bn_act(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                 act: float | None = None, skip: torch.Tensor | None = None) -> torch.Tensor:
    """``act(batch_norm(y) [+ skip])`` in one pass; the output keeps ``y``'s
    dtype and memory format. One launch on the card."""
    params = (weight, bias, running_mean, running_var)
    _check(y, params, skip, act)
    if y.is_cpu:
        return reference_bn_act(y, *params, eps, act, skip)
    if not y.is_cuda:
        raise ValueError(f"no kernel for device {y.device}")
    from fdtpu_torch.kernels import build

    out = torch.empty_like(y)  # y is dense: its strides, fresh storage
    code = 0 if act is None else (2 if act else 1)  # the kernel's: none, ReLU, LeakyReLU
    dev = y.get_device()
    n, c, h, w = y.shape
    args = (y.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(),
            *(p.data_ptr() for p in params), float(eps), code, float(act or 0.0),
            int(y.dtype == torch.bfloat16), n * h * w, c, torch._C._cuda_getCurrentRawStream(dev))
    lib = build.load_library()
    if torch.cuda.current_device() == dev:
        err = lib.fdtpu_bn_act(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.fdtpu_bn_act(*args)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: {build.cuda_error_string(err)}")
    LAUNCHES["bn_act"] += 1
    return out

