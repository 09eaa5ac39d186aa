"""Detector models; the zoo's PoolResnet is ported so far."""

from fdtpu_torch.models.detector import DTYPES, Detector, build_model  # noqa: F401
from fdtpu_torch.models.poolresnet import PoolResnet  # noqa: F401
