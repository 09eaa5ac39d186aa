"""Train and eval steps (``fdtpu/train/step.py``), for every family of the
zoo: the YOLO-grid models (PoolResnet, Resnet, SeparableCNN, MobileNetV3)
and the SSD.

One train step::

    u8 batch -> device augmentation (crop, rotation on the card's shear
    kernels, flip, photometric; with ``fused_photometric`` one launch of the
    photometric kernel) -> grid or prior target encoding -> forward with
    dropout -> YOLO loss or SSD hard-negative-mining loss -> SAM two-point
    gradients -> Adam (or SGD) at the MultiStep learning rate [-> decode
    through the NMS kernel + metrics]

fdtpu's choices that carry over: YOLO gradients use the batch-mean loss
while the reported ``loss`` is the reference's masked sum (the SSD loss is
already divided by its positive count and serves as both); the SSD
localisation target has the priors applied, so that it lives where the
model's output does (fdtpu's fix of the reference); ``grad_norm`` is the
global norm of the applied gradients; train metrics compare against the
augmented ground-truth boxes. fdtpu jits the step and returns a new state;
here it runs eagerly and updates the state in place. Every random choice of
a step (augmentation and dropout) is drawn from the state's generator
reseeded from ``(config.seed, step)``, so a step repeats exactly.

A step is a host prologue (reseed the generator, set the learning rate
from the schedule) and a device body (``step.prologue``, ``step.body``);
the body of a step, with metrics or without, over no group or an NCCL one,
is what ``train/graphs.py`` captures in a CUDA graph, fdtpu's jit, and
replays after the same prologue. The eval step's body (``step.body``, after
the default ``sample_mask``) is captured the same way.

BatchNorm state (MobileNetV3): the train step's forwards normalise by the
batch's statistics and the eval step's by the running ones, whatever
``nn.Module.training`` says. The running statistics are updated once a
step, from the forward at the unperturbed point: fdtpu takes the new
``batch_stats`` from the first evaluation (``sam_gradients``' ``aux``) and
drops the perturbed forward's.

Data parallelism: with a ``group`` (a ``torch.distributed`` process group)
each rank runs the step on its slice of the global batch, by one of fdtpu's
two routes (``fdtpu_torch/parallel/dp.py``). The Trainer takes the route
fdtpu's Trainer takes: shard_map's with ``rotate_device``, ``device_data``
or ``steps_per_dispatch`` > 1, GSPMD's otherwise (``parallel.trainer_route``).

* shard_map's (``route="shard_map"``, fdtpu's per-shard ``axis_name``
  body): the gradients are all-reduced by fdtpu's weighted form inside both
  SAM points, the reported loss is summed (the SSD's re-weighted by its
  positives), the BatchNorm running statistics (updated once, from the
  unperturbed forward) are averaged across the ranks, and the metrics are
  weighted by each rank's real samples.
* GSPMD's (``route="gspmd"``): for a BatchNorm model, every BatchNorm
  normalises by the global batch's statistics (its sums all-reduced over
  the group, ``parallel.batch_norm_over``), so the running statistics come
  out the same on every rank; each rank weighs its loss by its share of the
  global norm before the backward and the gradients are summed. The
  scalars are reduced as on shard_map's route. For the other families the
  two routes are one step, and this route runs shard_map's form.

The reductions are in ``fdtpu_torch/parallel/dp.py``. The rank folds into
the step's seed, as fdtpu folds ``axis_index`` into its key, so every rank
draws its own augmentation and dropout.

The spatial axis: with a ``mesh`` (``parallel/mesh.py``) the step is a
rank's of fdtpu's ``make_dp_train_step(spatial=True)``, for every family.
The ranks of a data row each get the row's whole slice of the batch,
augment it alike (the data index, not the rank, folds into the seed) and
encode the same targets; each keeps its rows of the float image and runs
the spatial forward (``parallel/spatial.py``), which gives every rank of
the row the whole output, so the loss is computed whole on each (the SSD's
mining ranks the whole map). A rank's gradient is the part from the rows
it owns, and the spatial ranks' parts sum to the row's gradient: the
mesh-wide all-reduce of fdtpu's weighted form sums over both axes, with
each row's norm counted once. MobileNetV3's BatchNorms sum their
statistics over the whole mesh, GSPMD's global batch; its loss is weighed
before the backward, as on the GSPMD route. The loss and the metrics, the
same on every rank of a row, are reduced over the data group only.

The train step's phases run under spans (``utils/trace.py``:
``train/augment``, ``train/targets``, ``train/gradients``,
``train/optimizer``, ``train/metrics``), which ``fdtpu_torch.profile_train``
reads for device time by phase. They are on only while a profiler is
active, and run where the body's host code runs: in an eager step, a
warm-up and a capture, not in a replay (``train/graphs.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from fdtpu_torch.core.grid import encode_grid_targets
from fdtpu_torch.core.nms import decode_filter_nms, ssd_output_filter_nms
from fdtpu_torch.core.priors import apply_priors, encode_ssd_targets, priors_on
from fdtpu_torch.data.augment import augment_batch_fast, resize_only_batch
from fdtpu_torch.losses.ssd import ssd_loss
from fdtpu_torch.losses.yolo import yolo_loss
from fdtpu_torch.compat.torch_import import ReferenceLayoutGrid
from fdtpu_torch.models.detector import has_batch_stats, is_ssd, refuse_served_only
from fdtpu_torch.models.layers import BatchNorm, DropoutMasks
from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.ssd import SSD
from fdtpu_torch.parallel.dp import (
    batch_norm_over,
    global_loss_scale,
    grad_all_reduce,
    mean_buffers,
    reduce_loss_sum,
    weighted_metric_reduce,
)
from fdtpu_torch.parallel.spatial import spatial_forward, spatial_plan
from fdtpu_torch.train.metrics import detection_metrics
from fdtpu_torch.train.sam import global_norm, sam_gradients
from fdtpu_torch.train.state import TrainState, set_learning_rate
from fdtpu_torch.utils import trace
from fdtpu_torch.utils.config import TrainConfig


def _check_supported(module) -> None:
    inner = module.inner if isinstance(module, ReferenceLayoutGrid) else module
    refuse_served_only(inner, "training and evaluation")
    if not isinstance(inner, (PoolResnet, MobileNetV3Backbone, SSD)):  # Resnet, SeparableCNN
        raise ValueError(f"{type(module).__name__} is not a detector of the zoo")


def step_seed(seed: int, step: int, rank: int | None = None) -> int:
    """The generator seed of one step: a hash of ``(seed, step)``, and of
    the rank for a rank of a data-parallel group."""
    entropy = [seed, step] if rank is None else [seed, step, rank]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def _prepare_inputs(images, boxes, box_mask, gen: torch.Generator | None,
                    rotate: bool = False, positional_crop: bool = False,
                    fused_photometric: bool = False):
    """u8 batch -> float batch in [0, 1] and its boxes: augmented when a
    generator is given, otherwise scaled with the min-area filter."""
    if gen is not None:
        return augment_batch_fast(gen, images, boxes, box_mask, rotate=rotate,
                                  positional_crop=positional_crop,
                                  fused_photometric=fused_photometric)
    return resize_only_batch(images, boxes, box_mask)


def _encode_targets(module, boxes, box_mask, image_size):
    """Padded pixel boxes -> ``(enc, gt_locs)``: ``(B, S, S, 5)`` grid
    targets at the model's actual output grid (its conv geometry, which may
    differ from ``num_patches``) and None; or ``(B, N, 5)`` prior targets
    and their ``(B, N, 4)`` locations with the priors applied, for the
    SSD."""
    if is_ssd(module):
        enc = encode_ssd_targets(boxes, box_mask, module.patch_sizes, image_size)
        return enc, apply_priors(enc, *priors_on(module.patch_sizes, enc.device))[..., 1:5]
    return encode_grid_targets(boxes, box_mask, module.grid_size(), image_size), None


def _decode_predictions(module, out, image_size, prob, iou, capacity):
    """Batched decode + filter + NMS of the model's output through the
    fused kernel (``kernels/nms.py``, K1) on the card."""
    if is_ssd(module):
        return ssd_output_filter_nms(out, image_size, prob, iou, capacity)
    return decode_filter_nms(out, module.grid_size(), image_size, prob, iou, capacity)


def _loss_norm(module, enc, sample_mask) -> torch.Tensor:
    """The count the gradient loss is divided by, before its clamp at 1:
    the real samples (YOLO), or the positive priors of the real samples
    (the SSD, ``SSDLoss.py:85-86``); the data-parallel reductions weigh
    each rank by it."""
    if is_ssd(module):
        return ((enc[..., 0] > 0) & sample_mask[:, None]).sum()
    return sample_mask.sum()


def _batch_stats(module) -> list[torch.Tensor]:
    """The running statistics of every BatchNorm (fdtpu's ``batch_stats``)."""
    return [t for m in module.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def _forward(module, images, masks: DropoutMasks | None, train: bool, update_stats: bool):
    """The model's forward: a BatchNorm model's in ``train`` mode or not
    (``update_stats``: fold the batch's statistics into the running ones),
    the others' with dropout when given ``masks``."""
    if has_batch_stats(module):
        return module(images, train=train, update_stats=update_stats)
    return module(images, masks)


def _loss_and_out(module, images, enc, sample_mask, masks: DropoutMasks | None = None,
                  gt_locs=None, neg_pos_ratio: int = 10, bg_push: float = 0.0,
                  train: bool = False, update_stats: bool = False, forward=_forward):
    """-> ``(gradient loss, (reported loss, model out))``. ``sample_mask``
    drops padded samples from both: their YOLO losses are masked out, their
    SSD labels zeroed (no positives, so no mined negatives either).
    ``forward`` is :func:`_forward`'s signature (the spatial step's own)."""
    out = forward(module, images, masks, train, update_stats)
    if is_ssd(module):
        enc = enc * sample_mask[:, None, None]
        loss = ssd_loss(out[..., 0], out[..., 1:5], enc[..., 0], gt_locs, neg_pos_ratio, bg_push)
        return loss, (loss, out)
    per_sample = yolo_loss(out, enc)
    loss_sum = torch.sum(per_sample * sample_mask)
    return loss_sum / sample_mask.sum().clamp_min(1), (loss_sum, out)


def _image_size(module) -> tuple[int, int]:
    h, w = module.input_shape
    return (w, h)


def make_train_step(
    module,
    config: TrainConfig,
    augment: bool = True,
    compute_metrics: bool = False,
    nms_params: tuple[float, float, int] = (0.5, 0.5, 64),
    group=None,
    neg_pos_ratio: int = 10,
    bg_push: float = 0.0,
    mesh=None,
    route: str = "shard_map",
) -> Callable:
    """Build the train step for ``module`` (the state's module);
    ``neg_pos_ratio`` and ``bg_push`` are the SSD loss's. With ``group``
    (a process group; None for one process) the step is a rank's of
    data-parallel training by ``route`` (module docstring): each rank
    passes its slice of the global batch and gets the same state and
    scalars back. With ``mesh`` as well (``group`` is the mesh's) it is a
    rank's of the data x spatial step: each rank passes its data row's
    slice.

    ``step(state, images_u8, boxes, box_mask, sample_mask=None) -> (state,
    scalars)``: ``images_u8`` ``(B, H, W, 3)``, ``boxes`` ``(B, N, 5)``
    pixel rows ``[conf, x, y, w, h]``, ``box_mask`` ``(B, N)``,
    ``sample_mask`` ``(B,)`` (all real by default), all on the module's
    device. ``scalars`` holds ``loss`` and ``grad_norm`` (and ``iou``,
    ``recall``, ``precision`` with ``compute_metrics``) as 0-d tensors.
    """
    _check_supported(module)
    image_size = _image_size(module)
    prob, iou_thr, capacity = nms_params
    rank = None if group is None else dist.get_rank(group)
    scalar_group, forward = group, _forward
    # the BatchNorm statistics span the ranks: GSPMD's global batch
    global_stats = group is not None and has_batch_stats(module) and (
        mesh is not None or route == "gspmd")
    if mesh is not None:
        rank, scalar_group = mesh.data_index, mesh.data_group
        plans = {module.input_shape[0]: spatial_plan(module, module.input_shape[0], mesh.spatial)}

        def forward(module, images, masks, train, update_stats):
            h = images.shape[1]
            if h not in plans:
                plans[h] = spatial_plan(module, h, mesh.spatial)
            a, b = plans[h].image_rows[mesh.spatial_index]
            return spatial_forward(module, images[:, a:b], plans[h], mesh, masks, train,
                                   update_stats)

    def prologue(state: TrainState) -> None:
        """The step's host part: reseed the generator and set the rate."""
        state.generator.manual_seed(step_seed(config.seed, state.step, rank))
        set_learning_rate(state.optimizer, state.schedule(state.step))

    def body(state: TrainState, images, boxes, box_mask, sample_mask) -> dict:
        """The step's device part, after :func:`prologue`: the params,
        the optimizer and the BatchNorm statistics change in place; the
        step count does not. It makes no host sync and no shape that
        depends on the data (the metrics' decode is K1 at a fixed
        capacity), its collectives included, so a CUDA graph can capture it
        (``train/graphs.py``)."""
        net = state.module
        gen = state.generator
        with trace.span("train/augment"):
            imgs, bx, bm = _prepare_inputs(
                images, boxes, box_mask, gen if augment else None,
                rotate=config.rotate_device, positional_crop=bool(config.positional_crop),
                fused_photometric=config.fused_photometric,
            )
        with trace.span("train/targets"):
            enc, gt_locs = _encode_targets(net, bx, bm, image_size)
        masks = DropoutMasks(gen)
        evaluations = 0
        norm = grad_reduce = loss_scale = None
        if group is not None:
            norm = _loss_norm(net, enc, sample_mask)
            if global_stats:  # weigh the loss before the backward, then sum
                loss_scale = global_loss_scale(scalar_group, norm)
                grad_reduce = grad_all_reduce(group, None)
            else:
                grad_reduce = grad_all_reduce(
                    group, norm, count_norm=mesh is None or mesh.spatial_index == 0)

        def loss_fn():
            nonlocal evaluations
            masks.rewind()  # both SAM points see the same dropout masks
            # BatchNorm's running statistics come from the first evaluation
            # only, the unperturbed point
            evaluations += 1
            loss, aux = _loss_and_out(net, imgs, enc, sample_mask, masks, gt_locs, neg_pos_ratio,
                                      bg_push, train=True, update_stats=evaluations == 1,
                                      forward=forward)
            return (loss, aux) if loss_scale is None else (loss * loss_scale, aux)

        params = [p for p in net.parameters() if p.requires_grad]
        with trace.span("train/gradients"), \
                batch_norm_over(net, group if global_stats else None):
            if config.use_sam:
                _, aux, grads = sam_gradients(loss_fn, params, config.sam_rho, grad_reduce)
            else:
                loss, aux = loss_fn()
                grads = torch.autograd.grad(loss, params)
                if grad_reduce is not None:
                    grads = grad_reduce(grads)
        loss_sum, out = aux
        if group is not None:
            loss_sum = reduce_loss_sum(scalar_group, loss_sum, norm, is_ssd(net))
            if not global_stats:
                mean_buffers(scalar_group, _batch_stats(net))

        with trace.span("train/optimizer"):
            opt = state.optimizer
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            scalars = {"loss": loss_sum.detach(), "grad_norm": global_norm(grads)}

        if compute_metrics:
            with trace.span("train/metrics"):
                pred_boxes, pred_mask = _decode_predictions(
                    net, out.detach(), image_size, prob, iou_thr, capacity)
                det = detection_metrics(pred_boxes, pred_mask, bx, bm, sample_mask)
                if group is not None:
                    det = weighted_metric_reduce(scalar_group, det, sample_mask)
                scalars.update(det)
        return scalars

    def step(state: TrainState, images, boxes, box_mask, sample_mask=None):
        if sample_mask is None:
            sample_mask = torch.ones(images.shape[:1], dtype=torch.bool, device=images.device)
        prologue(state)
        scalars = body(state, images, boxes, box_mask, sample_mask)
        state.step += 1
        return state, scalars

    # what a captured step (train/graphs.py) needs to know and run
    step.prologue, step.body = prologue, body
    step.compute_metrics, step.group, step.mesh = compute_metrics, group, mesh
    return step


def make_eval_step(
    module,
    nms_params: tuple[float, float, int] = (0.5, 0.5, 64),
    return_boxes: bool = False,
    group=None,
    neg_pos_ratio: int = 10,
    bg_push: float = 0.0,
) -> Callable:
    """Build the eval step: loss and the reference's metrics, and the
    decoded boxes with ``return_boxes``.

    ``step(state, images_u8, boxes, box_mask, sample_mask=None) -> scalars``
    (or ``(scalars, (pred_boxes, pred_mask))``); no augmentation, no dropout,
    BatchNorm on the running statistics.
    ``neg_pos_ratio`` and ``bg_push`` are the SSD loss's, as in training.
    With ``group`` each rank passes its slice of the batch: the loss and the
    metrics come back reduced across the ranks, the boxes are the rank's.
    A step is a host prologue (the default ``sample_mask``) and a device
    body (``step.body``), which ``train/graphs.py`` captures.
    """
    _check_supported(module)
    image_size = _image_size(module)

    @torch.no_grad()
    def body(state: TrainState, images, boxes, box_mask, sample_mask):
        """The step's device part: no host sync and no shape that depends on
        the data, its collectives included, so a CUDA graph can capture it
        (``train/graphs.py``: ``CapturedEvalStep``)."""
        imgs, bx, bm = _prepare_inputs(images, boxes, box_mask, None)
        enc, gt_locs = _encode_targets(state.module, bx, bm, image_size)
        _, (loss_sum, out) = _loss_and_out(state.module, imgs, enc, sample_mask, None, gt_locs,
                                           neg_pos_ratio, bg_push)
        norm = None if group is None else _loss_norm(state.module, enc, sample_mask)
        return eval_scalars(state.module, out, loss_sum, bx, bm, sample_mask, nms_params,
                            return_boxes, group, norm)

    def step(state: TrainState, images, boxes, box_mask, sample_mask=None):
        if sample_mask is None:  # the host prologue
            sample_mask = torch.ones(images.shape[:1], dtype=torch.bool, device=images.device)
        return body(state, images, boxes, box_mask, sample_mask)

    # what a captured step (train/graphs.py) needs to know and run
    step.body, step.group, step.mesh = body, group, None
    return step


def eval_scalars(module, out, loss_sum, boxes, box_mask, sample_mask,
                 nms_params=(0.5, 0.5, 64), return_boxes: bool = False, group=None, norm=None):
    """The eval step after its forward: decode ``out`` through the NMS
    kernel and score it against ``boxes``; with ``group``, reduce the loss
    (weighted by ``norm``, :func:`_loss_norm`) and the metrics across the
    ranks. Split out so that a forward output can be shared with fdtpu's
    step in the tests."""
    prob, iou_thr, capacity = nms_params
    pred_boxes, pred_mask = _decode_predictions(
        module, out, _image_size(module), prob, iou_thr, capacity)
    det = detection_metrics(pred_boxes, pred_mask, boxes, box_mask, sample_mask)
    if group is not None:
        loss_sum = reduce_loss_sum(group, loss_sum, norm, is_ssd(module))
        det = weighted_metric_reduce(group, det, sample_mask)
    scalars = {"loss": loss_sum}
    scalars.update(det)
    if return_boxes:
        return scalars, (pred_boxes, pred_mask)
    return scalars
