"""Data-parallel train and eval steps over ``torch.distributed``
(``fdtpu/parallel/dp.py``).

fdtpu has two builders that compute the same step: GSPMD's (the
single-device step jitted over a sharded batch) and shard_map's (the step
body run per shard, with the collectives placed by hand). Its Trainer takes
shard_map's whenever the step launches a Pallas kernel, since those run per
shard. Every rank here is a process that runs the step on its own slice of
the batch, which is shard_map's form, so the port has the one builder pair,
:func:`make_dp_train_step` and :func:`make_dp_eval_step`: the steps of
``train/step.py`` with a process group, whose reductions are below.

The reductions are fdtpu's (``fdtpu/train/step.py``), not a mean over the
ranks. A rank's gradient is that of its own mean loss, divided by its own
``max(norm, 1)`` (the count of real samples, or the SSD's count of positive
priors); each rank multiplies that divisor back, the ranks sum, and the sum
is divided by ``max(sum of norms, 1)``: the global batch's mean-loss
gradient, exact under uneven ``sample_mask`` and uneven positives. SAM
applies it at both of its points. ``DistributedDataParallel`` cannot: its
reducer divides by the world size and fires on ``.backward()``, and the step
takes its gradients with ``torch.autograd.grad`` twice.

Each reduction is one ``all_reduce`` of one flat float32 buffer (gloo
offers ``all_reduce`` and ``broadcast`` on CUDA tensors, and the code uses
no other collective). A failed collective raises; nothing here carries on
without it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist


def world_group(group=None):
    """``group``, or the default group (which must be initialised)."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("data-parallel steps need an initialised process group "
                           "(fdtpu_torch.parallel.initialize_multihost)")
    return dist.group.WORLD


def grad_all_reduce(group, norm: torch.Tensor,
                    count_norm: bool = True) -> Callable[[Sequence[torch.Tensor]], tuple]:
    """fdtpu's ``_grad_all_reduce``: ``reduce(grads)`` turns this rank's
    mean-loss gradients into the global batch's, in one all-reduce of one
    flat float32 buffer that also carries ``norm`` (this rank's divisor
    before the clamp at 1) as its last element. The gradients go in by one
    ``_foreach_copy_`` into views of the buffer with their own strides (a
    dense gradient, channels_last too, covers a contiguous block), and the
    views come back: the optimizer sees the params' layout.

    On a spatial mesh the ranks of a data row hold parts of one gradient,
    weighed by the row's one ``norm``: each multiplies its part by it, and
    only one of them (``count_norm``) adds the norm itself into the sum."""
    norm = norm.float().reshape(1)
    w_local = norm.clamp_min(1.0)

    def reduce(grads: Sequence[torch.Tensor]) -> tuple:
        flat = torch.empty(sum(g.numel() for g in grads) + 1, dtype=torch.float32,
                           device=norm.device)
        views, offset = [], 0
        for g in grads:
            views.append(flat.as_strided(g.shape, g.stride(), offset))
            offset += g.numel()
        torch._foreach_copy_(views, list(grads))
        flat[-1:].copy_(norm if count_norm else torch.zeros_like(norm))
        flat[:-1].mul_(w_local)
        dist.all_reduce(flat, group=group)
        flat[:-1].div_(flat[-1:].clamp_min(1.0))
        return tuple(views)

    return reduce


def reduce_loss_sum(group, loss_sum: torch.Tensor, norm: torch.Tensor,
                    normalized: bool) -> torch.Tensor:
    """fdtpu's ``_reduce_loss_sum``, the reported loss across ranks: a sum
    for YOLO's un-normalised sum; for the SSD's loss, already divided by
    the rank's positive count, the weighted form of
    :func:`grad_all_reduce`."""
    if not normalized:
        buf = loss_sum.detach().float().reshape(1).clone()
        dist.all_reduce(buf, group=group)
        return buf[0]
    norm = norm.float().reshape(1)
    buf = torch.cat([loss_sum.detach().float().reshape(1) * norm.clamp_min(1.0), norm])
    dist.all_reduce(buf, group=group)
    return buf[0] / buf[1].clamp_min(1.0)


def weighted_metric_reduce(group, det: dict, sample_mask: torch.Tensor) -> dict:
    """fdtpu's ``_weighted_metric_reduce``: each metric is a mean over the
    rank's real samples, so the global mean weighs it by their count."""
    n = sample_mask.sum().float().reshape(1)
    keys = list(det)
    buf = torch.cat([torch.stack([det[k].float() for k in keys]) * n, n])
    dist.all_reduce(buf, group=group)
    total = buf[-1].clamp_min(1.0)
    return {k: buf[i] / total for i, k in enumerate(keys)}


def mean_buffers(group, tensors: Sequence[torch.Tensor]) -> None:
    """fdtpu's ``pmean`` of ``batch_stats``, in place: each tensor becomes
    the mean of its value on every rank (the mean of each rank's own
    update, not the global batch's statistics, as in fdtpu)."""
    if not tensors:
        return
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view(t.shape))


def broadcast_module(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Every rank takes rank ``src``'s params and buffers (one broadcast per
    dtype), so that all start from the same state."""
    group = world_group(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(v.view(t.shape))


def barrier(group, device: torch.device | str) -> None:
    """Wait for every rank: an all-reduce of one element on ``device``."""
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag, group=group)
    flag.item()


def make_dp_train_step(module, config, group=None, mesh=None, **kwargs) -> Callable:
    """fdtpu's ``make_shardmap_dp_train_step``: the train step of
    ``train/step.py`` over ``group`` (the default group when None). Each
    rank calls it on its slice of every global batch; the state comes out
    the same on every rank. The rank's augmentation and dropout draws
    fold in its rank, as fdtpu folds in ``axis_index``. ``kwargs`` are
    ``make_train_step``'s.

    With ``mesh`` (``parallel/mesh.py``; ``group`` is then the mesh's) it
    is fdtpu's ``make_dp_train_step(spatial=True)``: each rank calls it on
    its data row of the batch (``parallel.data_shard``), the same on every
    rank of the row, and computes its rows of the height
    (``train/step.py``, "The spatial axis")."""
    from fdtpu_torch.train.step import make_train_step

    if mesh is not None:
        return make_train_step(module, config, group=mesh.group, mesh=mesh, **kwargs)
    return make_train_step(module, config, group=world_group(group), **kwargs)


def make_dp_eval_step(module, group=None, **kwargs) -> Callable:
    """fdtpu's ``make_shardmap_dp_eval_step``: the eval step over
    ``group``, its loss and metrics reduced across ranks; decoded boxes
    (``return_boxes``) stay the rank's own."""
    from fdtpu_torch.train.step import make_eval_step

    return make_eval_step(module, group=world_group(group), **kwargs)
