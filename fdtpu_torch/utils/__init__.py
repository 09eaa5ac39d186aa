"""Config and drawing utilities."""

from fdtpu_torch.utils.config import DetectorConfig, SSDConfig, TrainConfig  # noqa: F401
