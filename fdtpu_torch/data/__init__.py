"""WIDERFace data pipeline: annotation parsing, host image loading,
on-device augmentation, fixed-shape batching with a device prefetcher."""

from fdtpu_torch.data.widerface import (  # noqa: F401
    DATASET_LINKS,
    download_dataset_files,
    load_targets,
    parse_wider_annotations,
)
from fdtpu_torch.data.pipeline import (  # noqa: F401
    Batch,
    BatchLoader,
    DevicePrefetcher,
    WIDERFaceDataSource,
    make_synthetic_widerface,
    rotate_image_and_boxes,
)
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
