"""One ``torch.profiler`` window of a traced run, reduced to what the
per-layer metrics read.

The arithmetic is ``fdtpu_torch/profile_train.py``'s for one window: the
device is busy where any device operation runs (kernels, copies and fills:
the union of their intervals), idle for the rest of the window, whose
length is the host clock's from its start to the ``synchronize`` that
ends it; the host's launch calls are the CUDA runtime and driver calls
that put work on a stream. Its idle share of the unprofiled step, which
subtracts across two runs, is left out.

Beside these the window gives the ``breakdown`` of the result line: the
device operations that took most time, and the device's idle time by what
the host was doing when it began (the innermost event of the host's
thread open at that moment: one of the benchmark's ``perfbench/*`` spans,
a PyTorch operator or a CUDA call), the ten largest sums.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
WINDOW = "perfbench/window"


@dataclasses.dataclass
class Window:
    """A traced window: its length (host clock), the device's busy time,
    the device operations ``(name, seconds)`` summed by name, the host's
    launch calls and the idle gaps' seconds by what the host was doing."""

    window_s: float
    busy_s: float
    ops: dict
    launch_calls: int
    idle_by_host: dict

    def op_seconds(self, *parts: str) -> tuple[float, int]:
        """Seconds and count of the device operations whose name holds any
        of ``parts``."""
        hits = [(s, n) for name, (s, n) in self.ops.items() if any(p in name for p in parts)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((name[:120], s) for name, (s, _) in self.ops.items()), key=lambda x: -x[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda x: -x[1])
        return {"device_ops": [list(x) for x in ops[:top]],
                "idle_gaps": [[name[:120], s] for name, s in gaps[:top]]}


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_label(t: float, starts: list, events: list) -> str:
    """The innermost host event open at ``t``: the latest-starting one
    among those that began before it and end after it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        e = events[j]
        if e[1] >= t:
            return e[2]
    return "host: no traced event"


class Tracer:
    """A profiler window opened by ``start`` and closed by ``stop``, which
    may be called from different frames (a window that begins inside an
    epoch). ``start`` waits for the device first, so the window holds no
    work launched before it."""

    def __init__(self, device: torch.device):
        self.device = device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.span = record_function(WINDOW)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> "Window":
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.stop()
        return _reduce(self.prof, window_s)


def traced(run, device: torch.device):
    """``run()`` under the profiler -> ``(its result, Window)``."""
    tracer = Tracer(device)
    tracer.start()
    result = run()
    return result, tracer.stop()


def _reduce(prof, window_s: float) -> Window:
    events = prof.events()
    span = next(e for e in events if e.name == WINDOW)
    lo, hi = span.time_range.start, span.time_range.end
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and not e.name.startswith("perfbench/")]
    ops: dict = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in dev:
        ops[e.name][0] += e.time_range.elapsed_us() / 1e6
        ops[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy = _union(spans)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.thread == span.thread)
    starts = [h[0] for h in host]
    idle: dict = defaultdict(float)
    edge = lo
    for s, e in busy + [(hi, hi)]:
        if s > edge:
            idle[_host_label(edge, starts, host)] += (s - edge) / 1e6
        edge = max(edge, e)
    calls = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS)
    window = Window(window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e6,
                    ops={k: tuple(v) for k, v in ops.items()}, launch_calls=calls,
                    idle_by_host=dict(idle))
    return window
