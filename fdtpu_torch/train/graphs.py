"""The train and eval steps captured in CUDA graphs, the port's
counterpart of fdtpu's jitted steps, one compiled dispatch a batch or a
``lax.scan`` of them (``fdtpu/train/step.py``, ``fdtpu/train/drivers.py``:
``ScanDispatchDriver``, ``ResidentDriver._device_epoch`` and the resident
eval scan). The Trainer replays them for every batch on a card
(``train/loop.py``: ``Trainer.replays``; ``train/drivers.py``).

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

The metrics step (the epoch's last batch) is captured like any other: K1's
decode and the metrics are device ops, and the caller reads the scalars
after the replay. :class:`CapturedEvalStep` captures the eval step's body
(its host prologue is the default ``sample_mask``); it changes no state,
and reads the params and BatchNorm statistics of the module it captured.

One graph is kept per input shape (and per rate for SGD), as fdtpu keeps
one scan per group length. ``gather`` is the resident feed's form: the
graph gathers the batch's rows from the staged dataset by a static index
buffer, as fdtpu's epoch scan slices its permutation. The graphs of a
captured step share one private memory pool, or the owner's (the Trainer
gives its steps one).

Before a capture the body runs twice (``warmup``) on a side stream
(``utils/graphs.py``: the kernel libraries load, cuDNN and cuBLAS settle,
Adam's state exists); a train step's warm-up runs from a copy of the state,
which is put back afterwards, so the warm-up steps leave no trace (the
wrappers count their launches, which are real, and the graph keeps them:
:attr:`Graph.warm_launches`). The capture runs nothing: each graph keeps the launches its
capture recorded (:attr:`Graph.per_replay`, taken back out of
``kernels/launches.py``'s ``LAUNCHES``) and its :attr:`Graph.replays`, and
every replay adds its launches to ``LAUNCHES``, where the kernels' wrappers
count a launch when they run.

While a profiler is active (``utils/trace.py``) the call of a train or
metrics step is the span ``fdtpu/train/step`` (its unit the state's step
before the call: the feed's copy, the prologue, the replay's
``fdtpu/graph/replay``, the outputs' clones); the eval step's call has none.
A replay runs no host code, so the ``train/*`` phase spans of
``train/step.py`` run in eager steps, warm-ups and captures only.

A data-parallel or spatial step (``make_dp_train_step``,
``make_dp_eval_step``) is captured with its collectives: over an NCCL group
each ``dist.all_reduce`` is a kernel on NCCL's stream, which the capture
records as it records any other, so a replay runs the gradient all-reduce
at both SAM points, the loss, metric and BatchNorm reductions and the
spatial row exchanges and gather (``parallel/halo.py``) without the host.
Every rank of the group captures the same collectives in the same order,
as every rank runs the same step. Before the warm-up each of the step's
groups runs one eager all-reduce, which makes its NCCL communicator, since
none can be made inside a capture. A gloo group's collectives run on the
host, so a step over one raises, as does one with ``parallel.halo.timer``
set (its timing synchronises the card around each collective). The
prologue folds the rank into the generator's seed (``train/step.py``:
``step_seed``), so a rank's replay draws what its eager step draws.

On a CPU device a captured step raises ValueError, and a failed capture
raises, naming the rank; nothing falls back to the eager step.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from fdtpu_torch.parallel import halo
from fdtpu_torch.train.state import TrainState, init_optimizer_state, is_capturable
from fdtpu_torch.utils import trace
from fdtpu_torch.utils.graphs import (
    Graph,
    capture,
    capture_body,
    clone_outputs,
    require_card,
    warm_up,
)


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a train step writes: the params, the module's buffers
    (BatchNorm statistics) and the optimizer's state."""
    out = [p.data for p in state.module.parameters()]
    out += list(state.module.buffers())
    for s in state.optimizer.state.values():
        out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out


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
    """Raise ValueError where ``step`` cannot be captured: it runs over a
    group whose backend is not NCCL, or ``parallel.halo.timer`` is set."""
    for group in step_groups(step):
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(f"a step over a {backend} group is not captured: its collectives "
                             "run on the host; an NCCL group's are captured")
    if halo.timer is not None:
        raise ValueError("parallel.halo.timer synchronises the card around each collective, "
                         "which a capture cannot: set it to None")


class _CapturedStep:
    """A step captured in a CUDA graph per input shape (the train and eval
    steps' shared part): ``captured(state, images_u8, boxes, box_mask,
    sample_mask=None)`` copies the batch into the graph's static inputs;
    ``captured.gather(state, data, rows)`` takes the batch as the rows
    ``rows`` ``(B,)`` of ``data`` (``(images, boxes, box_mask,
    sample_mask)`` staged on the card), gathered inside the graph."""

    warmup = 2  # body runs before a capture
    traced_as = None  # the span of a call

    def __init__(self, step: Callable, pool=None):
        check_capturable(step)
        self.step = step
        self.pool = pool  # a graph_pool_handle the owner's graphs share, or None: one a graph
        self.rank = dist.get_rank(step.group) if step.group is not None else None
        self.graphs: dict[tuple, Graph] = {}
        self._retired_replays = 0  # replays of graphs an SGD rate replaced

    # -- calls ---------------------------------------------------------------------------

    def __call__(self, state: TrainState, images, boxes, box_mask, sample_mask=None):
        with self._span(state):
            if sample_mask is None:
                sample_mask = torch.ones(images.shape[:1], dtype=torch.bool,
                                         device=images.device)
            batch = (images, boxes, box_mask, sample_mask)
            key = ("batch",) + tuple((tuple(t.shape), t.dtype) for t in batch)
            g = self._graph(state, key, lambda: tuple(t.clone() for t in batch), lambda x: x)
            for buf, t in zip(g.inputs, batch):
                buf.copy_(t)
            return self._replay(g, state)

    def gather(self, state: TrainState, data: tuple, rows: torch.Tensor):
        with self._span(state):
            key = ("rows", tuple(rows.shape)) + tuple(id(t) for t in data)
            g = self._graph(state, key, lambda: (rows.clone(), data),
                            lambda x: tuple(t[x[0]] for t in x[1]))
            g.inputs[0].copy_(rows)
            return self._replay(g, state)

    @property
    def replays(self) -> int:
        return self._retired_replays + sum(g.replays for g in self.graphs.values())

    def _span(self, state: TrainState):
        """A call's span (``utils/trace.py``), its unit the state's step
        before the call; none where the class names none."""
        if self.traced_as is None:
            return contextlib.nullcontext()
        return trace.span(self.traced_as, state.step)

    # -- capture -------------------------------------------------------------------------

    def _graph(self, state: TrainState, key: tuple, make_inputs, feed) -> Graph:
        require_card(next(state.module.parameters()).device)
        self._check_state(state)
        lr = self._rate(state)
        g = self.graphs.get(key)
        if g is not None and g.lr != lr:  # SGD at a new rate: the old graph goes
            self._retired_replays += g.replays
            del self.graphs[key]
            g = None
        if g is None:
            g = self.graphs[key] = self._capture(state, make_inputs(), feed, lr)
        return g

    def _capture(self, state: TrainState, inputs, feed, lr) -> Graph:
        check_capturable(self.step)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            return self._warm_and_capture(state, inputs, feed, lr)
        except Exception as e:
            where = "" if self.rank is None else f" on rank {self.rank}"
            raise RuntimeError(f"capturing the {self.what} failed{where}: {e}") from e


class CapturedTrainStep(_CapturedStep):
    """``step`` (a ``make_train_step`` or ``make_dp_train_step``, with or
    without metrics, over no group or an NCCL one) captured in a CUDA graph
    per input shape.

    A call is the eager step's contract, ``-> (state, scalars)`` (clones of
    ``loss`` and ``grad_norm``, and of the metrics of a metrics step);
    ``state`` must be the one the graphs were captured on."""

    what = "train step"
    traced_as = "fdtpu/train/step"

    def __init__(self, step: Callable, pool=None):
        super().__init__(step, pool)
        self._state = None

    def _check_state(self, state: TrainState) -> None:
        if isinstance(state.optimizer, torch.optim.Adam) and not is_capturable(state.optimizer):
            raise ValueError("a captured step needs a capturable Adam: build the state with "
                             "create_train_state(..., capturable=True)")
        if self._state is None:
            self._state = state
        elif state is not self._state:
            raise ValueError("a CapturedTrainStep replays on the state it captured")

    @staticmethod
    def _rate(state: TrainState) -> float | None:
        return None if is_capturable(state.optimizer) else state.schedule(state.step)

    def _warm_and_capture(self, state: TrainState, inputs, feed, lr) -> Graph:
        device = next(state.module.parameters()).device
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register the step's generator "
                               "with a CUDA graph (CUDAGraph.register_generator_state)")

        def body():
            self.step.prologue(state)
            self.step.body(state, *feed(inputs))

        def warm():  # from a copy of the state, which is put back afterwards
            init_optimizer_state(state.optimizer)
            saved = [t.clone() for t in state_tensors(state)]
            warm_up(body, device, self.warmup, step_groups(self.step))
            with torch.no_grad():
                for t, s in zip(state_tensors(state), saved):
                    t.copy_(s)
            self.step.prologue(state)  # the rate the capture reads, for SGD

        g = capture(lambda: self.step.body(state, *feed(inputs)), device, inputs, self.pool,
                    state.generator, warm)
        g.lr = lr
        return g

    def _replay(self, g: Graph, state: TrainState):
        self.step.prologue(state)
        outputs = clone_outputs(g.replay())
        state.step += 1
        return state, outputs


class CapturedEvalStep(_CapturedStep):
    """``step`` (a ``make_eval_step`` or ``make_dp_eval_step``, over no group
    or an NCCL one, whose loss and metric all-reduces the graph captures)
    captured in a CUDA graph per input shape. A call is the eager step's
    contract, ``-> scalars`` or ``(scalars, (pred_boxes, pred_mask))``,
    clones; the graphs read the params and BatchNorm statistics of the
    module they were captured on, by address (a restore copies into them;
    another module raises)."""

    what = "eval step"

    def __init__(self, step: Callable, pool=None):
        super().__init__(step, pool)
        self._module = None

    def _check_state(self, state: TrainState) -> None:
        if self._module is None:
            self._module = state.module
        elif state.module is not self._module:
            raise ValueError("a CapturedEvalStep replays on the module it captured")

    @staticmethod
    def _rate(state: TrainState) -> None:
        return None

    def _warm_and_capture(self, state: TrainState, inputs, feed, lr) -> Graph:
        def body(*x):
            return self.step.body(state, *feed(x))

        return capture_body(body, inputs, self.pool, self.warmup, step_groups(self.step))

    def _replay(self, g: Graph, state: TrainState):
        return clone_outputs(g.replay())
