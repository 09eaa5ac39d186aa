"""Train and eval steps (``fdtpu/train/step.py``), for the PoolResnet
YOLO-grid family and the SSD.

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

The train step's phases run under ``torch.profiler.record_function`` spans
(``train/augment``, ``train/targets``, ``train/gradients``,
``train/optimizer``, ``train/metrics``), which ``fdtpu_torch.profile_train``
reads for device time by phase.

Not ported: the SPMD ``axis_name`` body with its cross-shard loss and
gradient reductions (ROADMAP.md queue 1, item 5), and the rest of the zoo
(item 4); both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from fdtpu_torch.core.grid import encode_grid_targets
from fdtpu_torch.core.nms import decode_filter_nms, ssd_output_filter_nms
from fdtpu_torch.core.priors import apply_priors, encode_ssd_targets, priors_on
from fdtpu_torch.data.augment import augment_batch_fast, resize_only_batch
from fdtpu_torch.losses.ssd import ssd_loss
from fdtpu_torch.losses.yolo import yolo_loss
from fdtpu_torch.models.detector import is_ssd
from fdtpu_torch.models.layers import DropoutMasks
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.ssd import SSD
from fdtpu_torch.train.metrics import detection_metrics
from fdtpu_torch.train.sam import global_norm, sam_gradients
from fdtpu_torch.train.state import TrainState
from fdtpu_torch.utils.config import TrainConfig


def _check_supported(module, axis_name) -> None:
    if not isinstance(module, (PoolResnet, SSD)):
        raise NotImplementedError(
            f"{type(module).__name__}: only PoolResnet and the SSD are ported "
            "(the rest of the zoo: ROADMAP.md queue 1, item 4)"
        )
    if axis_name is not None:
        raise NotImplementedError("data-parallel steps are not ported (ROADMAP.md queue 1, item 5)")


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step: a hash of ``(seed, step)``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


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


def _loss_norm(sample_mask) -> torch.Tensor:
    """The divisor from the summed loss to the gradient loss: the number of
    real samples, at least 1."""
    return sample_mask.sum().clamp_min(1)


def _loss_and_out(module, images, enc, sample_mask, masks: DropoutMasks | None = None,
                  gt_locs=None, neg_pos_ratio: int = 10, bg_push: float = 0.0):
    """-> ``(gradient loss, (reported loss, model out))``. ``sample_mask``
    drops padded samples from both: their YOLO losses are masked out, their
    SSD labels zeroed (no positives, so no mined negatives either)."""
    out = module(images, masks)
    if is_ssd(module):
        enc = enc * sample_mask[:, None, None]
        loss = ssd_loss(out[..., 0], out[..., 1:5], enc[..., 0], gt_locs, neg_pos_ratio, bg_push)
        return loss, (loss, out)
    per_sample = yolo_loss(out, enc)
    loss_sum = torch.sum(per_sample * sample_mask)
    return loss_sum / _loss_norm(sample_mask), (loss_sum, out)


def _image_size(module) -> tuple[int, int]:
    h, w = module.input_shape
    return (w, h)


def make_train_step(
    module,
    config: TrainConfig,
    augment: bool = True,
    compute_metrics: bool = False,
    nms_params: tuple[float, float, int] = (0.5, 0.5, 64),
    axis_name: str | None = None,
    neg_pos_ratio: int = 10,
    bg_push: float = 0.0,
) -> Callable:
    """Build the train step for ``module`` (the state's module);
    ``neg_pos_ratio`` and ``bg_push`` are the SSD loss's.

    ``step(state, images_u8, boxes, box_mask, sample_mask=None) -> (state,
    scalars)``: ``images_u8`` ``(B, H, W, 3)``, ``boxes`` ``(B, N, 5)``
    pixel rows ``[conf, x, y, w, h]``, ``box_mask`` ``(B, N)``,
    ``sample_mask`` ``(B,)`` (all real by default), all on the module's
    device. ``scalars`` holds ``loss`` and ``grad_norm`` (and ``iou``,
    ``recall``, ``precision`` with ``compute_metrics``) as 0-d tensors.
    """
    _check_supported(module, axis_name)
    image_size = _image_size(module)
    prob, iou_thr, capacity = nms_params

    def step(state: TrainState, images, boxes, box_mask, sample_mask=None):
        net = state.module
        if sample_mask is None:
            sample_mask = torch.ones(images.shape[:1], dtype=torch.bool, device=images.device)
        gen = state.generator
        gen.manual_seed(step_seed(config.seed, state.step))
        with record_function("train/augment"):
            imgs, bx, bm = _prepare_inputs(
                images, boxes, box_mask, gen if augment else None,
                rotate=config.rotate_device, positional_crop=bool(config.positional_crop),
                fused_photometric=config.fused_photometric,
            )
        with record_function("train/targets"):
            enc, gt_locs = _encode_targets(net, bx, bm, image_size)
        masks = DropoutMasks(gen)

        def loss_fn():
            masks.rewind()  # both SAM points see the same dropout masks
            return _loss_and_out(net, imgs, enc, sample_mask, masks, gt_locs, neg_pos_ratio,
                                 bg_push)

        params = [p for p in net.parameters() if p.requires_grad]
        with record_function("train/gradients"):
            if config.use_sam:
                _, aux, grads = sam_gradients(loss_fn, params, config.sam_rho)
            else:
                loss, aux = loss_fn()
                grads = torch.autograd.grad(loss, params)
        loss_sum, out = aux

        with record_function("train/optimizer"):
            opt = state.optimizer
            for group in opt.param_groups:
                group["lr"] = state.schedule(state.step)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            state.step += 1
            scalars = {"loss": loss_sum.detach(), "grad_norm": global_norm(grads)}

        if compute_metrics:
            with record_function("train/metrics"):
                pred_boxes, pred_mask = _decode_predictions(
                    net, out.detach(), image_size, prob, iou_thr, capacity)
                scalars.update(detection_metrics(pred_boxes, pred_mask, bx, bm, sample_mask))
        return state, scalars

    return step


def make_eval_step(
    module,
    nms_params: tuple[float, float, int] = (0.5, 0.5, 64),
    return_boxes: bool = False,
    axis_name: str | None = None,
    neg_pos_ratio: int = 10,
    bg_push: float = 0.0,
) -> Callable:
    """Build the eval step: loss and the reference's metrics, and the
    decoded boxes with ``return_boxes``.

    ``step(state, images_u8, boxes, box_mask, sample_mask=None) -> scalars``
    (or ``(scalars, (pred_boxes, pred_mask))``); no augmentation, no dropout.
    ``neg_pos_ratio`` and ``bg_push`` are the SSD loss's, as in training.
    """
    _check_supported(module, axis_name)
    image_size = _image_size(module)

    @torch.no_grad()
    def step(state: TrainState, images, boxes, box_mask, sample_mask=None):
        if sample_mask is None:
            sample_mask = torch.ones(images.shape[:1], dtype=torch.bool, device=images.device)
        imgs, bx, bm = _prepare_inputs(images, boxes, box_mask, None)
        enc, gt_locs = _encode_targets(state.module, bx, bm, image_size)
        _, (loss_sum, out) = _loss_and_out(state.module, imgs, enc, sample_mask, None, gt_locs,
                                           neg_pos_ratio, bg_push)
        return eval_scalars(state.module, out, loss_sum, bx, bm, sample_mask, nms_params,
                            return_boxes)

    return step


def eval_scalars(module, out, loss_sum, boxes, box_mask, sample_mask,
                 nms_params=(0.5, 0.5, 64), return_boxes: bool = False):
    """The eval step after its forward: decode ``out`` through the NMS
    kernel and score it against ``boxes``. Split out so that a forward
    output can be shared with fdtpu's step in the tests."""
    prob, iou_thr, capacity = nms_params
    pred_boxes, pred_mask = _decode_predictions(
        module, out, _image_size(module), prob, iou_thr, capacity)
    scalars = {"loss": loss_sum}
    scalars.update(detection_metrics(pred_boxes, pred_mask, boxes, box_mask, sample_mask))
    if return_boxes:
        return scalars, (pred_boxes, pred_mask)
    return scalars
