"""Milliseconds a served frame keeps the device busy over the traced
window: the copies in and out, ``/255``, the forward and K1."""

from perfbench.layer_metrics._common import per_unit


def read(ctx):
    return per_unit(ctx, "stream", ctx["window"].busy_s * 1e3)
