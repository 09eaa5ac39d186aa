"""Losses: the YOLO grid loss and the SSD hard-negative-mining loss."""

from fdtpu_torch.losses.ssd import hard_negative_mining, smooth_l1, ssd_loss, ssd_loss2  # noqa: F401
from fdtpu_torch.losses.yolo import COORD_WEIGHT, yolo_loss, yolo_loss_batch  # noqa: F401
