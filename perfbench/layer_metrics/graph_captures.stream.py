"""CUDA graphs the program captured in the traced window, per 1,000
frames: its ``graph_captures`` counter (``fdtpu_torch.utils.trace``). A
serving Detector captures at a key's first call, so a steady stream reads
0. None where the program keeps no ``fdtpu/predict`` spans, or not one a
frame."""

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "stream" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    if sum(s.name == "fdtpu/predict" for s in trace.records()) != ctx["units"]:
        return None
    return trace.counters().get("graph_captures", 0) * 1000 / ctx["units"]
