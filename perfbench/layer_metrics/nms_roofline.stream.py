"""K1, the fused decode + filter + NMS kernel (``decode_filter_nms_kernel``,
``core/nms.py`` -> ``kernels/nms.py``), against its bound on the frames it
served in the traced window: every candidate read and compared, each
eligible one (above the threshold in the reference's candidates of the
frame) decoded and tested once a greedy round of the answer
(``roofline/bounds.py``), over the kernel's time."""

from perfbench.layer_metrics._common import traced_device
from perfbench.roofline.bounds import nms_bound_s


def read(ctx):
    if ctx["mode"] != "stream" or not traced_device(ctx) or not ctx.get("nms"):
        return None
    seconds, launches = ctx["window"].op_seconds("decode_filter_nms")
    if not launches or seconds <= 0:
        return None
    bound = sum(count * nms_bound_s(n, eligible, kept, cap, ctx["peak"])
                for count, n, eligible, kept, cap in ctx["nms"])
    return 100.0 * bound / seconds
