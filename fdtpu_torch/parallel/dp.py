"""Data-parallel train and eval steps over ``torch.distributed``
(``fdtpu/parallel/dp.py``).

fdtpu has two builders. GSPMD's (``make_dp_train_step``) jits the
single-device step over a sharded batch, so a BatchNorm normalises by the
*global* batch's statistics. shard_map's (``make_shardmap_dp_train_step``)
runs the step body per shard, so a BatchNorm normalises by each shard's own
statistics and the running statistics are ``pmean``'d afterwards. For a
model without BatchNorm the two compute the same step; for MobileNetV3
they do not (one step apart by order 1e-2). fdtpu's Trainer takes
shard_map's whenever the step launches a Pallas kernel per shard
(``rotate_device``), the epoch runs on device-resident data
(``device_data``) or a dispatch scans several steps
(``steps_per_dispatch`` > 1), and GSPMD's otherwise: :func:`trainer_route`.

Every rank here is a process that runs the step on its own slice of the
batch, and :func:`make_dp_train_step` builds either route
(``route="shard_map"`` by default, or ``"gspmd"``): the steps of
``train/step.py`` with a process group, whose reductions are below. On the
GSPMD route a BatchNorm model's BatchNorms sum their statistics over the
group (:func:`batch_norm_over`); families without BatchNorm take the
shard_map form on either route, which is the same step.

The reductions are fdtpu's (``fdtpu/train/step.py``), not a mean over the
ranks. On the shard_map route a rank's gradient is that of its own mean
loss, divided by its own ``max(norm, 1)`` (the count of real samples, or
the SSD's count of positive priors); each rank multiplies that divisor
back, the ranks sum, and the sum is divided by ``max(sum of norms, 1)``:
the global batch's mean-loss gradient, exact under uneven ``sample_mask``
and uneven positives. Where the BatchNorm statistics span ranks, rank r's
loss reads every rank's activations through them, so part of its gradient
is computed on the other ranks, and a weight applied after the backward
would weigh that part by the wrong rank's norm: each rank weighs its loss
by ``max(norm, 1) / max(sum of norms, 1)`` *before* the backward, and the
gradients are summed. SAM applies the reduction at both of its points. ``DistributedDataParallel`` cannot: its reducer divides by
the world size and fires on ``.backward()``, and the step takes its
gradients with ``torch.autograd.grad`` twice.

Each reduction is one ``all_reduce`` of one flat float32 buffer (gloo
offers ``all_reduce`` and ``broadcast`` on CUDA tensors, and the code uses
no other collective). A failed collective raises; nothing here carries on
without it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from fdtpu_torch.models.layers import BatchNorm
from fdtpu_torch.parallel.halo import sum_over

ROUTES = ("shard_map", "gspmd")


def world_group(group=None):
    """``group``, or the default group (which must be initialised)."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("data-parallel steps need an initialised process group "
                           "(fdtpu_torch.parallel.initialize_multihost)")
    return dist.group.WORLD


def grad_all_reduce(group, norm: torch.Tensor | None,
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
    only one of them (``count_norm``) adds the norm itself into the sum.

    With ``norm`` None the gradients are only summed: those of losses each
    rank has already weighed (:func:`global_loss_scale`)."""
    if norm is not None:
        norm = norm.float().reshape(1)
        w_local = norm.clamp_min(1.0)

    def reduce(grads: Sequence[torch.Tensor]) -> tuple:
        extra = 0 if norm is None else 1
        flat = torch.empty(sum(g.numel() for g in grads) + extra, dtype=torch.float32,
                           device=grads[0].device)
        views, offset = [], 0
        for g in grads:
            views.append(flat.as_strided(g.shape, g.stride(), offset))
            offset += g.numel()
        torch._foreach_copy_(views, list(grads))
        if norm is None:
            dist.all_reduce(flat, group=group)
            return tuple(views)
        flat[-1:].copy_(norm if count_norm else torch.zeros_like(norm))
        flat[:-1].mul_(w_local)
        dist.all_reduce(flat, group=group)
        flat[:-1].div_(flat[-1:].clamp_min(1.0))
        return tuple(views)

    return reduce


def global_loss_scale(group, norm: torch.Tensor) -> torch.Tensor:
    """The factor that turns this rank's mean loss (divided by its own
    ``max(norm, 1)``) into its share of the global batch's:
    ``max(norm, 1) / max(sum of norms over group, 1)``. ``group`` holds one
    rank of each data row (a mesh's data group), so each row's norm counts
    once."""
    norm = norm.float().reshape(1)
    total = norm.clone()
    dist.all_reduce(total, group=group)
    return (norm.clamp_min(1.0) / total.clamp_min(1.0))[0]


@contextlib.contextmanager
def batch_norm_over(module: torch.nn.Module, group):
    """Within the block, every BatchNorm of ``module`` in ``train`` mode
    normalises by the statistics of the batch all ranks of ``group`` hold
    together (``BatchNorm.sum_reduce``: one autograd-aware sum over the
    group a layer). With no group, or a group of one rank, the layers stay
    as they are: ``F.batch_norm``, op for op."""
    if group is None or dist.get_world_size(group) == 1:
        yield
        return
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.sum_reduce for m in layers]
    reduce = functools.partial(sum_over, group=group, kind="bn")
    for m in layers:
        m.sum_reduce = reduce
    try:
        yield
    finally:
        for m, r in zip(layers, before):
            m.sum_reduce = r


def trainer_route(config) -> str:
    """The route fdtpu's Trainer takes (``fdtpu/train/loop.py``):
    shard_map's with ``rotate_device``, ``device_data`` or
    ``steps_per_dispatch`` > 1, GSPMD's otherwise."""
    shard_map = config.rotate_device or config.device_data or config.steps_per_dispatch > 1
    return "shard_map" if shard_map else "gspmd"


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


def make_dp_train_step(module, config, group=None, mesh=None, route: str = "shard_map",
                       **kwargs) -> Callable:
    """fdtpu's ``make_shardmap_dp_train_step`` (``route="shard_map"``) or
    ``make_dp_train_step`` (``route="gspmd"``; module docstring): the train
    step of ``train/step.py`` over ``group`` (the default group when None).
    Each rank calls it on its slice of every global batch; the state comes
    out the same on every rank. The rank's augmentation and dropout draws
    fold in its rank, as fdtpu's shard_map folds in ``axis_index``.
    ``kwargs`` are ``make_train_step``'s.

    With ``mesh`` (``parallel/mesh.py``; ``group`` is then the mesh's) it
    is fdtpu's ``make_dp_train_step(spatial=True)``, GSPMD's route: each
    rank calls it on its data row of the batch (``parallel.data_shard``),
    the same on every rank of the row, and computes its rows of the height
    (``train/step.py``, "The spatial axis")."""
    from fdtpu_torch.train.step import make_train_step

    if route not in ROUTES:
        raise ValueError(f"route {route!r}: want one of {ROUTES}")
    if mesh is not None:
        return make_train_step(module, config, group=mesh.group, mesh=mesh, **kwargs)
    return make_train_step(module, config, group=world_group(group), route=route, **kwargs)


def make_dp_eval_step(module, group=None, **kwargs) -> Callable:
    """fdtpu's ``make_shardmap_dp_eval_step``: the eval step over
    ``group``, its loss and metrics reduced across ranks; decoded boxes
    (``return_boxes``) stay the rank's own."""
    from fdtpu_torch.train.step import make_eval_step

    return make_eval_step(module, group=world_group(group), **kwargs)
