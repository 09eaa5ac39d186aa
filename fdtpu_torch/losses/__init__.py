"""Losses; the YOLO grid loss is ported so far (SSD: ROADMAP.md queue 1,
item 9)."""

from fdtpu_torch.losses.yolo import COORD_WEIGHT, yolo_loss, yolo_loss_batch  # noqa: F401
