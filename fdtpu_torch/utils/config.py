"""Detector, SSD and train configs: the same fields and defaults as
``fdtpu/utils/config.py``, duplicated so the port never imports fdtpu; and
:class:`RetinaFaceConfig`, a family the port serves beyond fdtpu's zoo."""

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
class SSDConfig:
    """SSD detector knobs; defaults mirror the reference's
    ``train_model_ssd.py:22-25`` and ``models/SSD.py:99`` (patch sizes ->
    4774 priors)."""

    filters: int = 16
    input_shape: Tuple[int, int] = (480, 480)
    patch_sizes: Tuple[int, ...] = (60, 30, 15, 7)
    probability_threshold: float = 0.5
    iou_threshold: float = 0.5
    nms_capacity: int = 128
    neg_pos_ratio: int = 10  # ModelMetaSSD.py:175
    # opt-in quality extension (not in the reference; see losses/ssd.py):
    # weight on the BCE of unmined background priors. 0.0 = faithful.
    bg_push: float = 0.0
    dtype: str = "bfloat16"

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.input_shape[1], self.input_shape[0])


@dataclasses.dataclass(frozen=True)
class RetinaFaceConfig:
    """RetinaFace-R50 knobs: ``cfg_re50`` of ``data/config.py`` in
    github.com/biubug6/Pytorch_Retinaface (a torchvision ResNet-50 whose
    ``layer2``-``layer4`` feed an FPN of ``out_channel``, two anchors a
    location, 840 px), with ``detect.py``'s serving thresholds: ``vis_thres``
    0.6, ``nms_threshold`` 0.4 and ``keep_top_k`` 750 rows. ``mean`` is the
    BGR mean the input transform subtracts. The port serves this model; it
    does not train it."""

    input_shape: Tuple[int, int] = (840, 840)  # (height, width)
    in_channels: Tuple[int, ...] = (512, 1024, 2048)  # layer2, layer3, layer4
    out_channel: int = 256
    min_sizes: Tuple[Tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512))
    steps: Tuple[int, ...] = (8, 16, 32)
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = False
    mean: Tuple[float, float, float] = (104.0, 117.0, 123.0)
    probability_threshold: float = 0.6
    iou_threshold: float = 0.4
    nms_capacity: int = 750
    dtype: str = "bfloat16"

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.input_shape[1], self.input_shape[0])


def serving_config(family: str, size: int, **zoo):
    """The config a serving entry point (``demo_model``,
    ``load_checkpoint``) builds ``family`` from at ``size`` px square:
    :class:`RetinaFaceConfig` for ``"retinaface"`` (``cfg_re50``'s widths,
    ``detect.py``'s thresholds and capacity), else a :class:`DetectorConfig`
    with ``zoo``'s fields (``build_model`` takes it for the SSD too)."""
    shape = (size, size)
    if family == "retinaface":
        return RetinaFaceConfig(input_shape=shape)
    return DetectorConfig(input_shape=shape, **zoo)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``fdtpu/utils/config.py:TrainConfig``, with the same
    defaults (the reference's config of record). ``steps_per_dispatch``:
    fdtpu's k steps in one ``lax.scan``; the port replays the train step
    captured in a CUDA graph for every batch on a card whatever k, and k
    groups the streamed batches for the log lines as fdtpu does
    (``train/drivers.py``: ``StreamedDriver``).
    ``data_parallel``: None, 0 or 1 for one process, ``n > 1`` for ``n``
    ranks of a ``torch.distributed`` group, -1 for the group's size (the
    Trainer checks the group and the batch)."""

    learning_rate: float = 1e-4
    optimizer: str = "adam"  # "adam" (reference SAMSGD base) or "sgd"
    max_epochs: int = 70
    batch_size: int = 8
    box_capacity: int = 8  # max gt boxes per image
    sam_rho: float = 0.05
    use_sam: bool = True
    lr_milestones: Tuple[int, ...] = (40,)  # MultiStepLR, in epochs
    lr_gamma: float = 0.1
    seed: int = 0
    log_every_steps: int = 50
    checkpoint_dir: str = "checkpoints"
    log_path: str = "logs/out.log"
    visualize_first_batch: bool = True
    # train-epoch detection metrics, on the final batch of each epoch
    train_metrics: bool = True
    # autograd anomaly detection (fdtpu: jax_debug_nans), see train/loop.py
    nan_check: bool = False
    data_parallel: int | None = None
    # train steps a dispatch: fdtpu's groups of k streamed batches (its scan)
    steps_per_dispatch: int = 1
    # stage the whole training set on the card once; each epoch is a
    # permutation on the card (train/drivers.py:ResidentDriver)
    device_data: bool = False
    # rotate on the card through the three-shear kernels (kernels/rotate.py)
    rotate_device: bool = False
    # crop the first k batch rows instead of a sampled subset; valid for
    # shuffled feeds only (see data/augment.py:augment_batch_fast)
    positional_crop: bool | None = None
    # the exact-k batch (B >= 16) in float32 through the fused photometric
    # kernel (kernels/photometric.py), fdtpu's FDTPU_PALLAS_AUGMENT=1 route
    fused_photometric: bool = False

    def __post_init__(self):
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch={self.steps_per_dispatch}: want 1 or more")
        if self.data_parallel is not None and self.data_parallel < -1:
            raise ValueError(f"data_parallel={self.data_parallel}: want None, -1 (the world "
                             "size), 0 or 1 (one process), or a number of ranks")
