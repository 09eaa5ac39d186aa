"""Milliseconds a traced train step's graph launch takes on the host: the
mean ``fdtpu/graph/replay`` span inside the program's ``fdtpu/train/step``
spans (``fdtpu_torch.utils.trace``). It holds the launch call's wait on a
full launch queue: near the step's time where the host runs ahead of the
card, short where the host sets the pace. None where the program keeps no
such spans, or not one a step, each with one replay."""

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
    return sum(launches[i][0] for i in steps) / len(steps) / 1e6
