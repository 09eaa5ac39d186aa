"""Deployment artifacts (``fdtpu/export``): the predict program through
``torch.export`` with K1 inside, a CUDA-graph predict, and the ``.fdn``
files of the native engine."""

from fdtpu_torch.export.export import (  # noqa: F401
    GraphPredict,
    PredictProgram,
    aot_compile_predict,
    export_predict,
    export_program,
    load_exported,
)
from fdtpu_torch.export.native_format import export_native  # noqa: F401
