"""Milliseconds a train step keeps the device busy (the union of its
device operations' intervals) over the traced window: the model step's
own device time."""

from perfbench.layer_metrics._common import per_unit


def read(ctx):
    return per_unit(ctx, "train", ctx["window"].busy_s * 1e3)
