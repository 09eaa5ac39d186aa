"""Detector models: fdtpu's zoo (PoolResnet, Resnet, SeparableCNN,
MobileNetV3, SSD) and the serving facade."""

from fdtpu_torch.models.detector import (  # noqa: F401
    DTYPES,
    FAMILIES,
    Detector,
    build_model,
    has_batch_stats,
    is_ssd,
)
from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone  # noqa: F401
from fdtpu_torch.models.poolresnet import PoolResnet  # noqa: F401
from fdtpu_torch.models.resnet import Resnet  # noqa: F401
from fdtpu_torch.models.separable import SeparableCNN  # noqa: F401
from fdtpu_torch.models.ssd import SSD, ssd_patch_sizes  # noqa: F401
