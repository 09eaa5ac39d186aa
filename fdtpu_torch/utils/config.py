"""Detector and train configs: the same fields and defaults as
``fdtpu/utils/config.py``, duplicated so the port never imports fdtpu."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """YOLO-grid detector family knobs.

    Defaults mirror the reference's ``train_model.py:15-32``: 480x480 input,
    10x10 grid, 128 filters, 10 residual blocks.
    """

    filters: int = 128
    input_shape: Tuple[int, int] = (480, 480)  # (height, width)
    num_patches: int = 10
    num_residual_blocks: int = 10
    probability_threshold: float = 0.5
    iou_threshold: float = 0.5
    nms_capacity: int = 128
    # PoolResnet stem/head geometry (reference models/PoolResnet.py:57-61)
    input_kernel_size: int = 10
    input_stride: int = 8
    output_kernel_size: int = 6
    output_padding: int = 0
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    # fdtpu's two-stage stem lowering. It has the plain stem's math and param
    # tree, so the port always runs the plain conv and ignores this field;
    # it stays so one config drives both packages.
    fast_stem: bool = False

    @property
    def image_size(self) -> Tuple[int, int]:
        """(width, height) as used by box encode/decode."""
        return (self.input_shape[1], self.input_shape[0])


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``fdtpu/utils/config.py:TrainConfig`` that the train
    step reads, with the same defaults (the reference's config of record).
    The loop's fields (epochs, logging, checkpoints, data parallelism) come
    with the Trainer (ROADMAP.md queue 1, item 8)."""

    learning_rate: float = 1e-4
    optimizer: str = "adam"  # "adam" (reference SAMSGD base) or "sgd"
    batch_size: int = 8
    box_capacity: int = 8  # max gt boxes per image
    sam_rho: float = 0.05
    use_sam: bool = True
    lr_milestones: Tuple[int, ...] = (40,)  # MultiStepLR, in epochs
    lr_gamma: float = 0.1
    seed: int = 0
    # rotate on the card through the three-shear kernels (kernels/rotate.py)
    rotate_device: bool = False
    # crop the first k batch rows instead of a sampled subset; valid for
    # shuffled feeds only (see data/augment.py:augment_batch_fast)
    positional_crop: bool | None = None
    # the exact-k batch (B >= 16) in float32 through the fused photometric
    # kernel (kernels/photometric.py), fdtpu's FDTPU_PALLAS_AUGMENT=1 route
    fused_photometric: bool = False
