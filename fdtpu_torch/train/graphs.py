"""The train step captured in a CUDA graph, the port's counterpart of
fdtpu's jitted step, one compiled dispatch a batch or a ``lax.scan`` of
them (``fdtpu/train/step.py``, ``fdtpu/train/drivers.py``:
``ScanDispatchDriver``, ``ResidentDriver._device_epoch``). The Trainer
replays it for every batch but the metrics one, whatever
``steps_per_dispatch`` is (``train/drivers.py``).

On the H100 the eager step is host-bound: ~1,800 to 4,300 kernel launches a
step leave the card idle for a third to nine tenths of it. A graph of the
step's device body (``train/step.py``: ``step.body``) is launched as one
unit. A call of :class:`CapturedTrainStep` runs the step's host prologue
(reseed the state's generator from ``(seed, step)``, set the learning rate
from the schedule), copies the batch into the graph's static input
buffers, replays the graph and counts the step, so that it draws what the
eager step draws and updates the same tensors in place:

* the generator is registered with the graph, so a replay draws from its
  seed and offset at replay time, the ones the prologue just set;
* Adam must be capturable (``create_train_state(..., capturable=True)``,
  ``train/state.py``; a plain one raises): its rate is a tensor on the
  card, filled by the prologue, and its step counts live on the card;
  SGD's rate is a host scalar of its update, so a new rate captures the
  step again (the schedule changes it at milestone epochs only);
* the params, the BatchNorm statistics and Adam's moments are the state's
  own tensors, which the graph reads and writes by address: a restore
  copies into them (``train/checkpoint.py``).

One graph is kept per input shape (and per rate for SGD), as fdtpu keeps
one scan per group length. :meth:`CapturedTrainStep.gather` is the resident
feed's form: the graph gathers the batch's rows from the staged dataset by
a static index buffer, as fdtpu's epoch scan slices its permutation.

Before a capture the body runs twice (``warmup``) on a side stream (the
kernel libraries load, cuDNN and cuBLAS settle, Adam's state exists) from a
copy of the state, which is put back afterwards, so the warm-up steps leave
no trace (the wrappers count their launches, which are real;
:attr:`CapturedTrainStep.warmed` counts the bodies). The capture runs
nothing. The kernels' wrappers count a launch when they run, which a replay
does not: each graph keeps the launches its capture recorded
(:attr:`Graph.per_replay`, taken back out of the wrappers' counts) and its
:attr:`Graph.replays`, and every replay adds its launches to
:data:`REPLAYED`, the count of all graphs' replays by wrapper.

A data-parallel or spatial step (``make_dp_train_step``) is captured with
its collectives: over an NCCL group each ``dist.all_reduce`` is a kernel on
NCCL's stream, which the capture records as it records any other, so a
replay runs the gradient all-reduce at both SAM points, the loss and
BatchNorm reductions and the spatial row exchanges and gather
(``parallel/halo.py``) without the host. Every rank of the group captures
the same collectives in the same order, as every rank runs the same step.
Before the warm-up each of the step's groups runs one eager all-reduce,
which makes its NCCL communicator, since none can be made inside a capture.
A gloo group's collectives run on the host, so a step over one raises, as
does one with ``parallel.halo.timer`` set (its timing synchronises the card
around each collective). The prologue folds the rank into the generator's
seed (``train/step.py``: ``step_seed``), so a rank's replay draws what its
eager step draws.

A step with metrics (K1's decode and the metrics' host copy) is not
captured: it runs eagerly. On a CPU device a ``CapturedTrainStep`` raises
ValueError, and a failed capture raises, naming the rank; nothing falls
back to the eager step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from fdtpu_torch.kernels.photometric import photometric_batch
from fdtpu_torch.kernels.rotate import shear_cols, shear_rows
from fdtpu_torch.parallel import halo
from fdtpu_torch.train.state import TrainState, init_optimizer_state, is_capturable

# the wrappers whose launches a graph counts (a captured step has no
# metrics, so no K1): name -> (function, attribute)
COUNTED = {
    "shear_rows": (shear_rows, "launches"),
    "shear_rows_stacked": (shear_rows, "stacked_launches"),
    "shear_cols": (shear_cols, "launches"),
    "photometric": (photometric_batch, "launches"),
}


# the kernel launches of every replay of every captured step, by wrapper
REPLAYED = {k: 0 for k in COUNTED}


def wrapper_counts() -> dict:
    """The wrappers' own launch counts (a replay does not tick them)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTED.items()}


def _set_counts(counts: dict) -> None:
    for k, (fn, attr) in COUNTED.items():
        setattr(fn, attr, counts[k])


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a train step writes: the params, the module's buffers
    (BatchNorm statistics) and the optimizer's state."""
    out = [p.data for p in state.module.parameters()]
    out += list(state.module.buffers())
    for s in state.optimizer.state.values():
        out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out


@dataclasses.dataclass
class Graph:
    """One captured step: the graph, its static inputs (the batch, or the
    row indices), its outputs, the kernel launches one replay makes, the
    bytes its private pool took and the seconds the warm-up and capture
    took."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: dict
    per_replay: dict
    pool_bytes: int
    capture_s: float
    lr: float | None
    replays: int = 0


def step_groups(step) -> list:
    """The process groups whose collectives ``step`` runs: its group and,
    on a mesh, the mesh's data and spatial groups."""
    if step.group is None:
        return []
    groups = [step.group]
    if step.mesh is not None:
        groups += [g for g in (step.mesh.data_group, step.mesh.spatial_group)
                   if g is not None and g not in groups]
    return groups


def check_capturable(step) -> None:
    """Raise ValueError where ``step`` cannot be captured: it has metrics,
    it runs over a group whose backend is not NCCL, or
    ``parallel.halo.timer`` is set."""
    if step.compute_metrics:
        raise ValueError("a train step with metrics is not captured (K1's decode and the "
                         "metrics' host copy run eagerly)")
    for group in step_groups(step):
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(f"a step over a {backend} group is not captured: its collectives "
                             "run on the host; an NCCL group's are captured")
    if halo.timer is not None:
        raise ValueError("parallel.halo.timer synchronises the card around each collective, "
                         "which a capture cannot: set it to None")


class CapturedTrainStep:
    """``step`` (a ``make_train_step`` or ``make_dp_train_step`` without
    metrics, over no group or an NCCL one) captured in a CUDA graph per
    input shape.

    ``captured(state, images_u8, boxes, box_mask, sample_mask=None) ->
    (state, scalars)`` is the eager step's contract (clones of ``loss`` and
    ``grad_norm``); ``captured.gather(state, data, rows)`` takes the batch
    as the rows ``rows`` ``(B,)`` of ``data`` (``(images, boxes, box_mask,
    sample_mask)`` staged on the card). ``state`` must be the one the graphs
    were captured on."""

    warmup = 2  # body runs before a capture

    def __init__(self, step: Callable):
        check_capturable(step)
        self.step = step
        self.rank = dist.get_rank(step.group) if step.group is not None else None
        self.graphs: dict[tuple, Graph] = {}
        self._retired = {k: 0 for k in COUNTED}  # launches of graphs an SGD rate replaced
        self._retired_replays = 0
        self._state = None
        self.warmed = 0  # bodies run in warm-ups

    # -- calls ---------------------------------------------------------------------------

    def __call__(self, state: TrainState, images, boxes, box_mask, sample_mask=None):
        if sample_mask is None:
            sample_mask = torch.ones(images.shape[:1], dtype=torch.bool, device=images.device)
        batch = (images, boxes, box_mask, sample_mask)
        key = ("batch",) + tuple((tuple(t.shape), t.dtype) for t in batch)
        g = self._graph(state, key, lambda: tuple(t.clone() for t in batch), lambda x: x)
        for buf, t in zip(g.inputs, batch):
            buf.copy_(t)
        return self._replay(g, state)

    def gather(self, state: TrainState, data: tuple, rows: torch.Tensor):
        key = ("rows", tuple(rows.shape)) + tuple(id(t) for t in data)
        g = self._graph(state, key, lambda: (rows.clone(), data),
                        lambda x: tuple(t[x[0]] for t in x[1]))
        g.inputs[0].copy_(rows)
        return self._replay(g, state)

    def launches(self) -> dict:
        """The kernel launches of every replay so far, by wrapper."""
        return {k: self._retired[k] + sum(g.per_replay[k] * g.replays
                                          for g in self.graphs.values())
                for k in COUNTED}

    @property
    def replays(self) -> int:
        return self._retired_replays + sum(g.replays for g in self.graphs.values())

    # -- capture -------------------------------------------------------------------------

    def _graph(self, state: TrainState, key: tuple, make_inputs, feed) -> Graph:
        device = next(state.module.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a card, got the state on {device}")
        if isinstance(state.optimizer, torch.optim.Adam) and not is_capturable(state.optimizer):
            raise ValueError("a captured step needs a capturable Adam: build the state with "
                             "create_train_state(..., capturable=True)")
        if self._state is None:
            self._state = state
        elif state is not self._state:
            raise ValueError("a CapturedTrainStep replays on the state it captured")
        lr = None if is_capturable(state.optimizer) else state.schedule(state.step)
        g = self.graphs.get(key)
        if g is not None and g.lr != lr:  # SGD at a new rate: the old graph goes
            for k in COUNTED:
                self._retired[k] += g.per_replay[k] * g.replays
            self._retired_replays += g.replays
            del self.graphs[key]
            g = None
        if g is None:
            g = self.graphs[key] = self._capture(state, make_inputs(), feed, lr)
        return g

    def _capture(self, state: TrainState, inputs, feed, lr) -> Graph:
        check_capturable(self.step)
        try:
            return self._warm_and_capture(state, inputs, feed, lr)
        except Exception as e:
            where = "" if self.rank is None else f" on rank {self.rank}"
            raise RuntimeError(f"capturing the train step failed{where}: {e}") from e

    def _warm_and_capture(self, state: TrainState, inputs, feed, lr) -> Graph:
        device = next(state.module.parameters()).device
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register the step's generator "
                               "with a CUDA graph (CUDAGraph.register_generator_state)")
        t0 = time.perf_counter()
        init_optimizer_state(state.optimizer)
        saved = [t.clone() for t in state_tensors(state)]
        # warm up from the state, on a side stream, then put the state back;
        # one eager all-reduce a group first makes its NCCL communicator
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for group in step_groups(self.step):
                dist.all_reduce(torch.zeros(1, device=device), group=group)
            for _ in range(self.warmup):
                self.step.prologue(state)
                self.step.body(state, *feed(inputs))
                self.warmed += 1
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state_tensors(state), saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(device)

        counts = wrapper_counts()  # the warm-up's launches were real and stay counted
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        torch.cuda.empty_cache()  # as the capture does first: its pool is what it adds
        reserved = torch.cuda.memory_reserved(device)
        self.step.prologue(state)  # the rate the capture reads, for SGD
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self.step.body(state, *feed(inputs))
        torch.cuda.synchronize(device)
        after = wrapper_counts()
        per_replay = {k: after[k] - counts[k] for k in COUNTED}
        _set_counts(counts)
        return Graph(graph, inputs, outputs, per_replay,
                     torch.cuda.memory_reserved(device) - reserved,
                     time.perf_counter() - t0, lr)

    def _replay(self, g: Graph, state: TrainState):
        self.step.prologue(state)
        g.graph.replay()
        g.replays += 1
        for k, n in g.per_replay.items():
            REPLAYED[k] += n
        state.step += 1
        return state, {k: v.clone() for k, v in g.outputs.items()}
