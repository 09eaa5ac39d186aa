"""The system under test, ``fdtpu_torch``, built from a configuration file
as its entry points build it: ``train_model`` / ``train_model_ssd`` for a
Trainer, ``load_checkpoint`` for a serving Detector. The weights are the
benchmark's, loaded into the module the program builds."""

from __future__ import annotations

import torch


def model_config(config: dict):
    """The program's ``DetectorConfig`` or ``SSDConfig`` of a
    configuration."""
    from fdtpu_torch.utils.config import DetectorConfig, SSDConfig

    m, d = config["model"], config["detector"]
    common = dict(input_shape=tuple(m["input_shape"]),
                  probability_threshold=d["probability_threshold"],
                  iou_threshold=d["iou_threshold"], nms_capacity=d["nms_capacity"],
                  dtype=config["compute_dtype"])
    if config["family"] == "ssd":
        t = config["train"]
        return SSDConfig(filters=m["filters"], patch_sizes=tuple(m["patch_sizes"]),
                         neg_pos_ratio=t["neg_pos_ratio"], bg_push=t["bg_push"], **common)
    return DetectorConfig(filters=m["filters"], num_patches=m["num_patches"],
                          num_residual_blocks=m["num_residual_blocks"],
                          input_kernel_size=m["input_kernel_size"],
                          input_stride=m["input_stride"],
                          output_kernel_size=m["output_kernel_size"],
                          output_padding=m["output_padding"], **common)


def module(config: dict, weights: dict, device: torch.device, train: bool) -> torch.nn.Module:
    """The program's float32 module holding ``weights``; one to train
    computes in the configuration's dtype (a serving Detector casts its own
    copy). Built under the device, so that the program's own initial draw,
    which the weights replace, is made there."""
    from fdtpu_torch.models import DTYPES, build_model

    with torch.device(device):
        net = build_model(config["family"], model_config(config), device,
                          compute_dtype=DTYPES[config["compute_dtype"]] if train else None)
    net.load_state_dict(weights, strict=True)
    return net
