"""Core box math: conversions, IoU, grid target encoding and decoding,
decode+filter+NMS."""

from fdtpu_torch.core.boxes import (  # noqa: F401
    box_area,
    box_iou,
    pad_boxes,
    xywh_to_xyxy,
    xyxy_to_xywh,
)
from fdtpu_torch.core.grid import decode_grid, encode_grid_targets  # noqa: F401
from fdtpu_torch.core.nms import compact_boxes, decode_filter_nms  # noqa: F401
