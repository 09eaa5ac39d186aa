"""Milliseconds a traced request spends in ``Detector.predict``: the mean
of the program's ``fdtpu/predict`` spans (``fdtpu_torch.utils.trace``,
host clock), one a frame. None where the program keeps no such spans, or
not one a frame."""

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "stream" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    spans = [s for s in trace.records() if s.name == "fdtpu/predict"]
    if len(spans) != ctx["units"]:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6
