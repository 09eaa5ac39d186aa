"""Hand-written Hopper kernels with their plain PyTorch versions. The build
module (``kernels/build.py``) is imported only when a kernel launches.
``conv_gemm.py`` holds no hand-written kernel: a convolution as one library
GEMM, counted as the kernels' wrappers are. ``launches.py`` holds the one
count of every launch, :data:`LAUNCHES`."""

from fdtpu_torch.kernels.bn_act import fused_bn_act, reference_bn_act  # noqa: F401
from fdtpu_torch.kernels.epilogue import fused_residual_tail, reference_tail  # noqa: F401
from fdtpu_torch.kernels.launches import LAUNCHES  # noqa: F401
from fdtpu_torch.kernels.nms import (  # noqa: F401
    decode_filter_nms_batch,
    decode_filter_nms_reference,
    grid_decode_tables,
    grid_tables_on,
    ssd_decode_tables,
    ssd_output_decode_tables,
    ssd_output_tables_on,
    ssd_tables_on,
)
from fdtpu_torch.kernels.photometric import (  # noqa: F401
    photometric_batch,
    photometric_reference,
)
from fdtpu_torch.kernels.rotate import (  # noqa: F401
    ROTATE_LIMIT_RAD,
    rotate_batch,
    rotate_batch_reference,
    rotate_batch_transposed,
    rotate_batch_transposed_reference,
    rotate_boxes,
    shear_cols,
    shear_cols_reference,
    shear_rows,
    shear_rows_reference,
)
