"""The SSD as ``train_model_ssd`` builds it: an ``SSDConfig``, and the
Trainer's mining ratio and background push from the configuration."""

from __future__ import annotations

MODEL = "ssd"  # the name the program's build_model takes


def model_config(config: dict):
    """The program's ``SSDConfig`` of a configuration."""
    from fdtpu_torch.utils.config import SSDConfig

    m, d, t = config["model"], config["detector"], config["train"]
    return SSDConfig(filters=m["filters"], patch_sizes=tuple(m["patch_sizes"]),
                     neg_pos_ratio=t["neg_pos_ratio"], bg_push=t["bg_push"],
                     input_shape=tuple(m["input_shape"]),
                     probability_threshold=d["probability_threshold"],
                     iou_threshold=d["iou_threshold"], nms_capacity=d["nms_capacity"],
                     dtype=config["compute_dtype"])


def loss_kwargs(config: dict) -> dict:
    """The Trainer's loss arguments."""
    t = config["train"]
    return {"neg_pos_ratio": t["neg_pos_ratio"], "bg_push": t["bg_push"]}
