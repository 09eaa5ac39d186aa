"""Data: on-device augmentation. The loader and the WIDERFace source come
with the Trainer (ROADMAP.md queue 1, item 8)."""

from fdtpu_torch.data.augment import (  # noqa: F401
    ExactKDraws,
    SampleDraws,
    apply_exact_k,
    apply_per_sample,
    augment_batch_fast,
    resize_only_batch,
    sample_exact_k,
    sample_per_sample,
)
