"""Milliseconds from the start of a traced ``Detector.predict`` to the end
of its graph's launch: the mean, over the program's ``fdtpu/predict`` spans
(``fdtpu_torch.utils.trace``), of the time to the end of their
``fdtpu/graph/replay`` child. In a closed loop the card waits through it.
None where the program keeps no such spans, or not one a frame, each with
its replay."""

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "stream" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    spans = trace.records()
    units = {i for i, s in enumerate(spans) if s.name == "fdtpu/predict"}
    replayed = {s.parent: s.end_ns for s in spans
                if s.name == "fdtpu/graph/replay" and s.parent in units}
    if len(units) != ctx["units"] or len(replayed) != len(units):
        return None
    return sum(replayed[i] - spans[i].start_ns for i in units) / len(units) / 1e6
