"""The port's spans and counters: on while a ``torch.profiler`` profile is
active in the calling thread (an operator's ``torch.profiler.profile()``,
``Trainer.profile``, a benchmark's traced window), off every other time.

Off, :func:`span` costs one ``torch.autograd._profiler_enabled()`` check and
returns a shared no-op context; :func:`count` the same check. On, a span
enters ``torch.profiler.record_function(name)``, so it is an event on the
profiler's own timeline (the one its CUDA device events are placed on; a
Chrome trace exported from the profile shows it), and also appends a
:class:`Span` to a list this module keeps: its name, start and end by
``time.perf_counter_ns()``, the index of the enclosing span of its thread
(``parent``) and ``unit``, the request or step it belongs to (given, or the
enclosing span's). Beyond :data:`CAP` records a span is dropped from the list
and :func:`dropped` counts it. :func:`records`, :func:`counters` and
:func:`clear` read and empty what is held; the profile's trace is the one
exporter.

The names are a contract: PERF.md and the benchmark's readers use them.

* ``fdtpu/predict`` (unit: the Detector's call number), with children
  ``fdtpu/predict/host_frame``, ``fdtpu/predict/stage`` (the card path's
  staging buffer, graph lookup and copy in), ``fdtpu/graph/replay`` and
  ``fdtpu/predict/release`` (``models/detector.py``);
* ``fdtpu/train/step`` (unit: the state's step before it), a replayed train
  or metrics step, with its ``fdtpu/graph/replay`` (``train/graphs.py``);
* ``fdtpu/graph/replay`` and ``fdtpu/graph/capture`` with the counter
  ``graph_captures``, around every replay and every capture with its
  warm-up (``utils/graphs.py``);
* the counter ``nms_scratch``: K1's launches on its global-scratch path
  (more than ``max_candidates`` rows an image) that replays made
  (``utils/graphs.py``, from the graph's ``per_replay``);
* the eager train step's phases ``train/augment``, ``train/targets``,
  ``train/gradients``, ``train/optimizer``, ``train/metrics``
  (``train/step.py``, read by ``profile_train``) and the spatial
  collectives' ``spatial/*`` (``parallel/halo.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

CAP = 1 << 20  # spans held; beyond it they are dropped and counted

_records: list[Span] = []
_counters: dict[str, int] = {}
_dropped = 0
_lock = threading.Lock()
_local = threading.local()  # each thread's stack of open spans' indices
_OFF = contextlib.nullcontext()  # what a span is with tracing off


@dataclasses.dataclass(slots=True)
class Span:
    """A span as held: ``end_ns`` is None while it is open; ``parent`` is
    the index in :func:`records` of the span it opened inside."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    unit: int | None


class _On:
    __slots__ = ("name", "unit", "span", "event")

    def __init__(self, name: str, unit: int | None):
        self.name, self.unit = name, unit

    def __enter__(self):
        global _dropped
        stack = _stack()
        parent = stack[-1] if stack else None
        unit = self.unit
        if unit is None and parent is not None:
            unit = _records[parent].unit
        self.event = record_function(self.name)
        self.event.__enter__()
        self.span = Span(self.name, time.perf_counter_ns(), None, parent, unit)
        with _lock:
            if len(_records) < CAP:
                stack.append(len(_records))
                _records.append(self.span)
            else:
                stack.append(None)
                _dropped += 1
        return self

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        _stack().pop()
        self.event.__exit__(*exc)
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, unit: int | None = None):
    """A context that records ``name`` while tracing is on, and does
    nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _On(name, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _profiler_enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def records() -> list[Span]:
    """The spans held, in the order they opened."""
    with _lock:
        return list(_records)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """The spans not held since the last :func:`clear`, beyond :data:`CAP`."""
    return _dropped


def clear() -> None:
    """Empty the spans, the counters and the dropped count; call it with no
    span open."""
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0
