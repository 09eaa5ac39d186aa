"""The host's CUDA launch calls a train step (kernel and graph launches,
copies and fills) over the traced window: what dispatch costs a replayed
step (``train/graphs.py``, ``utils/graphs.py``, ``train/drivers.py``)."""

from perfbench.layer_metrics._common import per_unit


def read(ctx):
    return per_unit(ctx, "train", ctx["window"].launch_calls)
