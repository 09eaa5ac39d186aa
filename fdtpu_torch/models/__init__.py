"""Detector models; the zoo's PoolResnet and the SSD are ported so far."""

from fdtpu_torch.models.detector import DTYPES, Detector, build_model, is_ssd  # noqa: F401
from fdtpu_torch.models.poolresnet import PoolResnet  # noqa: F401
from fdtpu_torch.models.ssd import SSD, ssd_patch_sizes  # noqa: F401
