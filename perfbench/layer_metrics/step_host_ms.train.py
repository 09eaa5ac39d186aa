"""Milliseconds of the host's own work a traced train step: the mean, over
the program's ``fdtpu/train/step`` spans (``fdtpu_torch.utils.trace``), of
the span less its ``fdtpu/graph/replay`` child (the feed's copy, the
prologue, the outputs' clones). None where the program keeps no such
spans, or not one a step, each with one replay."""

from collections import defaultdict

from perfbench.layer_metrics._common import traced_device


def read(ctx):
    if ctx["mode"] != "train" or not traced_device(ctx):
        return None
    try:
        from fdtpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    spans = trace.records()
    steps = {i for i, s in enumerate(spans) if s.name == "fdtpu/train/step"}
    launches = defaultdict(list)
    for s in spans:
        if s.name == "fdtpu/graph/replay" and s.parent in steps:
            launches[s.parent].append(s.end_ns - s.start_ns)
    if len(steps) != ctx["units"] or any(len(launches[i]) != 1 for i in steps):
        return None
    own = sum(spans[i].end_ns - spans[i].start_ns - launches[i][0] for i in steps)
    return own / len(steps) / 1e6
