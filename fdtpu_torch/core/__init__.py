"""Core box math: conversions, IoU, grid and SSD prior target encoding and
decoding, decode+filter+NMS."""

from fdtpu_torch.core.boxes import (  # noqa: F401
    box_area,
    box_iou,
    pad_boxes,
    xywh_to_xyxy,
    xyxy_to_xywh,
)
from fdtpu_torch.core.grid import decode_grid, encode_grid_targets  # noqa: F401
from fdtpu_torch.core.nms import (  # noqa: F401
    compact_boxes,
    decode_filter_nms,
    ssd_decode_filter_nms,
    ssd_output_filter_nms,
)
from fdtpu_torch.core.priors import (  # noqa: F401
    DEFAULT_PATCH_SIZES,
    apply_priors,
    calculate_priors,
    decode_ssd,
    encode_ssd_targets,
    num_priors,
    prior_scales,
)
