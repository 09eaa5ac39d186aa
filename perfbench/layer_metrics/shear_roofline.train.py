"""The rotation's shear kernels (``shear_rows_kernel``,
``shear_cols_kernel``; K3a, K3b) against their bound: the planes each
launch moves, read once and written once (``roofline/bounds.py``), over
the kernels' time in the traced window. A launch's planes are read from
its arguments as the program made its launches in set-up, whose graphs the
window replays (the mean a launch where they differ). Nothing where the
step does not rotate."""

from perfbench.layer_metrics._common import traced_device
from perfbench.roofline.bounds import shear_bound_s


def read(ctx):
    seen = ctx.get("shear_launches")
    if ctx["mode"] != "train" or not seen or not traced_device(ctx):
        return None
    seconds, launches = ctx["window"].op_seconds("shear_rows_kernel", "shear_cols_kernel")
    if not launches or seconds <= 0:
        return None
    per_launch = sum(shear_bound_s(n, size, ctx["peak"]) for n, size in seen) / len(seen)
    return 100.0 * launches * per_launch / seconds
