"""CUDA graphs the program captured in the traced window, per 1,000 train
steps: its ``graph_captures`` counter (``fdtpu_torch.utils.trace``). The
Trainer captures its train and metrics steps at their first calls, in the
first epoch, so later epochs read 0. None where the program keeps no
``fdtpu/train/step`` spans, or not one a step."""

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "train" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    if sum(s.name == "fdtpu/train/step" for s in trace.records()) != ctx["units"]:
        return None
    return trace.counters().get("graph_captures", 0) * 1000 / ctx["units"]
