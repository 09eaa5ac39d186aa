"""The whole train step's share of the card's dense bfloat16 peak: the
analytic FLOPs of SAM's two forwards and backwards (``roofline/flops.py``)
of every image of the traced window, over its length."""

from perfbench.layer_metrics._common import mfu_percent


def read(ctx):
    return mfu_percent(ctx, "train")
