"""The served frames' share of the card's dense bfloat16 peak: the
forward's analytic FLOPs (``roofline/flops.py``) of every frame of the
traced window, over its length."""

from perfbench.layer_metrics._common import mfu_percent


def read(ctx):
    return mfu_percent(ctx, "stream")
