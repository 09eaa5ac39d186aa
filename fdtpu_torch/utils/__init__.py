"""Config and drawing utilities."""

from fdtpu_torch.utils.config import DetectorConfig  # noqa: F401
