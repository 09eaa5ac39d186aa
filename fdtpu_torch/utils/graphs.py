"""Device bodies captured in CUDA graphs, the port's counterpart of fdtpu's
``jax.jit``: one helper for every captured program (``export.GraphPredict``,
the :class:`~fdtpu_torch.models.Detector`'s ``predict`` and
``non_max_suppression``, and the train and eval steps of
``train/graphs.py``).

A program is captured from static inputs: tensors on the card that a call
fills (``copy_``) before it replays the graph. Before the capture the body
runs on a side stream (:func:`warm_up`), so that the kernels' library, K1's
shared-memory limit, the decode tables and cuDNN's and cuBLAS's choices are
settled; :func:`capture` then records the body once into a private memory
pool, which an owner (a Detector, a Trainer) may share between its graphs
(``torch.cuda.graph_pool_handle``): they replay one at a time on one stream
and each replay's outputs are cloned before the next replay, so no graph
reads what another wrote.

Kernel launches are counted in ``kernels/launches.py``'s ``LAUNCHES`` by
the wrappers where they run. The warm-up's launches are real and stay
counted; the graph keeps them as :attr:`Graph.warm_launches`. The capture
runs nothing, so its launches are taken back out of
``LAUNCHES`` into the graph's :attr:`Graph.per_replay`, and a replay, which
passes no wrapper, adds them to ``LAUNCHES`` again: ``LAUNCHES`` is every
launch on the card.

While a profiler is active (``utils/trace.py``) every capture, its warm-up
included, is the span ``fdtpu/graph/capture`` and adds one to the counter
``graph_captures``, and every replay's launch is the span
``fdtpu/graph/replay``, a child of its caller's span (a predict, a train
step); a replay of a graph that holds K1 on its global-scratch path adds
those launches to the counter ``nms_scratch``.

On a CPU device nothing is captured: the helpers raise ValueError, and a
failed capture raises; nothing falls back to the eager body.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.utils import trace


def require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a card, got {device}")


def clone_outputs(outputs):
    """A copy of a graph's outputs (tensors in tuples and dicts), which the
    next replay overwrites."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, outputs)


@dataclasses.dataclass
class Graph:
    """One captured program: the graph, its static inputs, its outputs,
    the kernel launches one replay makes by name (a kernel it lacks reads
    0), the bytes the capture added to the reserved memory, the seconds
    the warm-up and capture took and the kernel launches of the warm-up."""

    graph: torch.cuda.CUDAGraph
    inputs: Any
    outputs: Any
    per_replay: collections.Counter
    pool_bytes: int
    capture_s: float
    warm_launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    lr: float | None = None  # the rate an SGD step was captured at
    replays: int = 0

    def replay(self):
        """Replay the graph and count its launches; returns its static
        outputs (:func:`clone_outputs` before the next replay)."""
        with trace.span("fdtpu/graph/replay"):
            self.graph.replay()
        self.replays += 1
        LAUNCHES.update(self.per_replay)
        if self.per_replay["decode_filter_nms_scratch"]:
            trace.count("nms_scratch", self.per_replay["decode_filter_nms_scratch"])
        return self.outputs


class GraphCache:
    """Graphs by key, made at a key's first use; beyond ``size`` graphs the
    least recently used one goes (its memory back to the pool)."""

    def __init__(self, size: int):
        self.size = size
        self.graphs: collections.OrderedDict[Any, Graph] = collections.OrderedDict()

    def get(self, key, make: Callable[[], Graph]) -> Graph:
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
            return g
        g = self.graphs[key] = make()
        while len(self.graphs) > self.size:
            self.graphs.popitem(last=False)
        return g

    def __len__(self) -> int:
        return len(self.graphs)


def warm_up(run: Callable[[], Any], device: torch.device, n: int, groups=()) -> None:
    """``run()`` ``n`` times on a side stream, after one eager all-reduce on
    each of ``groups``, which makes its NCCL communicator (none can be made
    inside a capture); the current stream then waits for it."""
    require_card(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for group in groups:
            dist.all_reduce(torch.zeros(1, device=device), group=group)
        for _ in range(n):
            run()
    torch.cuda.current_stream(device).wait_stream(side)


def capture(run: Callable[[], Any], device: torch.device, inputs=None, pool=None,
            generator: torch.Generator | None = None,
            warm: Callable[[], Any] | None = None) -> Graph:
    """Capture ``run()`` into a graph whose outputs are what it returns,
    after ``warm()`` (a :func:`warm_up`, and whatever the caller does
    between it and the capture); ``pool`` is a ``graph_pool_handle`` to
    share, ``generator`` a generator whose seed and offset a replay reads at
    replay time (``CUDAGraph.register_generator_state``).
    :attr:`Graph.capture_s`, the span ``fdtpu/graph/capture`` and the counter
    ``graph_captures`` (``utils/trace.py``) cover the warm-up and the
    capture."""
    require_card(device)
    with trace.span("fdtpu/graph/capture"):
        trace.count("graph_captures")
        t0, before = time.perf_counter(), LAUNCHES.copy()
        if warm is not None:
            warm()
        torch.cuda.synchronize(device)
        warm_launches = LAUNCHES - before
        before = LAUNCHES.copy()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.empty_cache()  # as the capture does first: its pool is what it adds
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.device(device), \
                torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            outputs = run()
        torch.cuda.synchronize(device)
        per_replay = LAUNCHES - before
        LAUNCHES.subtract(per_replay)  # the capture ran nothing
        return Graph(graph, inputs, outputs, per_replay,
                     torch.cuda.memory_reserved(device) - reserved, time.perf_counter() - t0,
                     warm_launches)


def capture_body(body: Callable[..., Any], inputs: tuple, pool=None, warmup: int = 2,
                 groups=()) -> Graph:
    """``body(*inputs)`` warmed up and captured, ``inputs`` its static
    inputs on the card: the stateless programs' form of
    :func:`warm_up` and :func:`capture`."""
    device = inputs[0].device
    return capture(lambda: body(*inputs), device, inputs, pool,
                   warm=lambda: warm_up(lambda: body(*inputs), device, warmup, groups))
