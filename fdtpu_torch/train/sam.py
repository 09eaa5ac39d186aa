"""Sharpness-Aware Minimization as a two-point gradient
(``fdtpu/train/sam.py``).

Gradients at the original point ``g``, then the gradients at
``params + rho * g / (||g||_2 + 1e-12)``, the norm taken over all params.
fdtpu evaluates ``loss_fn`` on a perturbed copy of its params pytree; here
the params are perturbed in place and restored from a saved copy
(subtracting the step again would not give the same floats back). The
caller's ``loss_fn`` replays the same dropout masks at both points.
``grad_reduce``, the data-parallel gradient all-reduce, applies to both
gradient evaluations, so that the perturbation follows the global gradient
(``fdtpu/train/sam.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all elements (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def sam_gradients(loss_fn: Callable[[], tuple[torch.Tensor, object]],
                  params: Sequence[torch.Tensor], rho: float,
                  grad_reduce: Callable[[Sequence[torch.Tensor]], tuple] | None = None):
    """``loss_fn() -> (loss, aux)`` evaluated at the params' current values.

    Returns ``(loss, aux, grads)``: ``loss`` and ``aux`` at the original
    point, ``grads`` (a tuple, one per param) at the perturbed point, each
    gradient passed through ``grad_reduce`` when given. The params hold
    their original values again on return.
    """
    loss, aux = loss_fn()
    grads = torch.autograd.grad(loss, params)
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    scale = rho / (global_norm(grads) + 1e-12)
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.add_(g * scale)
    try:
        sam_loss, _ = loss_fn()
        sam_grads = torch.autograd.grad(sam_loss, params)
        if grad_reduce is not None:
            sam_grads = grad_reduce(sam_grads)
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    return loss, aux, sam_grads
