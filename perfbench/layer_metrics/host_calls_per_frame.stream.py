"""The host's CUDA launch calls a served frame over the traced window:
the serving entry's staging, graph replay and output clones
(``models/detector.py``)."""

from perfbench.layer_metrics._common import per_unit


def read(ctx):
    return per_unit(ctx, "stream", ctx["window"].launch_calls)
