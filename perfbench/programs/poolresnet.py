"""PoolResnet's grid detector as ``train_model`` and ``load_checkpoint``
build it: a ``DetectorConfig``, and the Trainer's default loss."""

from __future__ import annotations

MODEL = "poolresnet"  # the name the program's build_model takes


def model_config(config: dict):
    """The program's ``DetectorConfig`` of a configuration."""
    from fdtpu_torch.utils.config import DetectorConfig

    m, d = config["model"], config["detector"]
    return DetectorConfig(filters=m["filters"], num_patches=m["num_patches"],
                          num_residual_blocks=m["num_residual_blocks"],
                          input_kernel_size=m["input_kernel_size"],
                          input_stride=m["input_stride"],
                          output_kernel_size=m["output_kernel_size"],
                          output_padding=m["output_padding"],
                          input_shape=tuple(m["input_shape"]),
                          probability_threshold=d["probability_threshold"],
                          iou_threshold=d["iou_threshold"], nms_capacity=d["nms_capacity"],
                          dtype=config["compute_dtype"])


def loss_kwargs(config: dict) -> dict:
    """The Trainer's loss arguments: its defaults, which only the SSD's
    loss reads."""
    return {}
