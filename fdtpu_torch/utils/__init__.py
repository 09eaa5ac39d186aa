"""Config and drawing utilities."""

from fdtpu_torch.utils.config import DetectorConfig, TrainConfig  # noqa: F401
