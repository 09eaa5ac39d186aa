"""Milliseconds of K1 (``decode_filter_nms_kernel``) a served frame on its
global-scratch path, over the traced window: the kernel's device time over
the frames. None unless the program's counter ``nms_scratch``
(``fdtpu_torch.utils.trace``, a graph replay's scratch launches) reads
exactly one a frame."""

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "stream" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    if trace.counters().get("nms_scratch", 0) != ctx["units"]:
        return None
    seconds, launches = ctx["window"].op_seconds("decode_filter_nms")
    if launches != ctx["units"]:
        return None
    return seconds * 1e3 / ctx["units"]
