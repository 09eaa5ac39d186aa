"""The port's tracer (``fdtpu_torch/utils/trace.py``): off without a
profiler (no ``record_function``, no record), on under
``torch.profiler.profile`` (the same spans on the profiler's timeline and
in ``records()``), the spans ``Detector.predict`` and a captured train
step keep, and the benchmark's six readers of them
(``perfbench/layer_metrics/``). No jax here, so the ``gpu`` tests run on a
machine without it: ``python -m pytest --noconftest
tests/test_torch_trace.py``."""

import collections
import time
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch.profiler import ProfilerActivity, profile

from fdtpu_torch.models import Detector, PoolResnet
from fdtpu_torch.train.graphs import CapturedTrainStep
from fdtpu_torch.utils import trace
from fdtpu_torch.utils.graphs import Graph
from perfbench.cell import reader

SIZE = (160, 160)
PREDICT = ("fdtpu/predict", "fdtpu/predict/host_frame", "fdtpu/predict/stage",
           "fdtpu/graph/replay", "fdtpu/predict/release")


@pytest.fixture(autouse=True)
def cleared():
    trace.clear()
    yield
    trace.clear()


def refuse_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(trace, "record_function", refused)


def cpu_detector():
    torch.manual_seed(0)
    return Detector(PoolResnet(8, SIZE, 5, 2), nms_capacity=16)


def frame(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*SIZE, 3), dtype=np.uint8)


class FakeStep:
    """A train step's interface as ``CapturedTrainStep`` calls it, for a
    replay on the CPU: no group, a prologue that counts."""

    group = mesh = None

    def __init__(self):
        self.prologues = 0

    def prologue(self, state):
        self.prologues += 1


def cpu_captured_step(monkeypatch):
    """A ``CapturedTrainStep`` whose graph is a stand-in (the CPU has no
    CUDA graph): a call copies the batch in, replays, clones and counts the
    step as on a card."""
    captured = CapturedTrainStep(FakeStep())

    def graph(state, key, make_inputs, feed):
        return Graph(types.SimpleNamespace(replay=lambda: None), make_inputs(),
                     {"loss": torch.ones(())}, collections.Counter(), 0, 0.0)

    monkeypatch.setattr(captured, "_graph", graph)
    batch = (torch.zeros(2, 4, 4, 3, dtype=torch.uint8), torch.zeros(2, 1, 5),
             torch.zeros(2, 1, dtype=torch.bool), torch.ones(2, dtype=torch.bool))
    return captured, types.SimpleNamespace(step=5), batch


def test_off_enters_no_record_function_and_records_nothing(monkeypatch):
    refuse_record_function(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    with trace.span("outer", 1):
        with trace.span("inner"):
            pass
    trace.count("graph_captures")
    cpu_detector().predict(frame())
    captured, state, batch = cpu_captured_step(monkeypatch)
    captured(state, *batch)
    captured.gather(state, batch, torch.arange(2))
    assert state.step == 7 and captured.step.prologues == 2
    assert trace.records() == [] and trace.counters() == {} and trace.dropped() == 0


def test_spans_on_the_profilers_timeline_and_in_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for unit in (3, 4):
            with trace.span("test/outer", unit):
                with trace.span("test/inner"):
                    time.sleep(0.005)
                with trace.span("test/inner", 9):
                    pass
    held = trace.records()
    assert [s.name for s in held] == ["test/outer", "test/inner", "test/inner"] * 2
    assert [s.parent for s in held] == [None, 0, 0, None, 3, 3]
    assert [s.unit for s in held] == [3, 3, 9, 4, 4, 9]
    events = sorted((e for e in prof.events() if e.name.startswith("test/")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [s.name for s in held]
    for e, s in zip(events, held):
        if s.parent is not None:  # nested on the timeline too
            outer = events[s.parent].time_range
            assert outer.start <= e.time_range.start <= e.time_range.end <= outer.end
        if s.name == "test/inner" and s.unit != 9:  # around the 5 ms sleep
            ours = (s.end_ns - s.start_ns) / 1e3
            assert ours >= 5000
            assert abs(ours - e.time_range.elapsed_us()) <= 0.1 * ours


def test_cap_counts_dropped_and_count_is_gated(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 2)
    trace.count("graph_captures", 5)
    assert trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.span("test/capped"):
                pass
        trace.count("graph_captures")
        trace.count("graph_captures", 2)
    assert len(trace.records()) == 2 and trace.dropped() == 1
    assert trace.counters() == {"graph_captures": 3}
    trace.clear()
    assert trace.records() == [] and trace.counters() == {} and trace.dropped() == 0


def test_cpu_predict_spans_share_their_unit():
    det = cpu_detector()
    det.predict(frame())
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (1, 2):
            det.predict(frame(seed))
    held = trace.records()
    calls = [i for i, s in enumerate(held) if s.name == "fdtpu/predict"]
    frames = [s for s in held if s.name == "fdtpu/predict/host_frame"]
    assert len(calls) == len(frames) == 2
    assert [held[i].unit for i in calls] == [1, 2]
    assert [(s.parent, s.unit) for s in frames] == [(i, held[i].unit) for i in calls]


def test_captured_step_span_holds_its_replay(monkeypatch):
    captured, state, batch = cpu_captured_step(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        captured(state, *batch)
        captured.gather(state, batch, torch.arange(2))
    held = trace.records()
    assert [(s.name, s.parent, s.unit) for s in held] == [
        ("fdtpu/train/step", None, 5), ("fdtpu/graph/replay", 0, 5),
        ("fdtpu/train/step", None, 6), ("fdtpu/graph/replay", 2, 6)]


# -- the benchmark's readers ---------------------------------------------------------------

MS = 1_000_000  # ns


def stream_records():
    """Two requests: predict 0-4 ms with its replay ending at 3 ms, predict
    10-12 ms with its replay ending at 11 ms."""
    S = trace.Span
    return [S("fdtpu/predict", 0, 4 * MS, None, 0), S("fdtpu/predict/host_frame", 0, MS, 0, 0),
            S("fdtpu/graph/replay", 2 * MS, 3 * MS, 0, 0),
            S("fdtpu/predict", 10 * MS, 12 * MS, None, 1),
            S("fdtpu/graph/replay", 10 * MS, 11 * MS, 3, 1),
            S("fdtpu/graph/replay", 20 * MS, 21 * MS, None, None)]  # an NMS replay


def train_records():
    """Two steps: 0-6 ms with a 5 ms replay, 10-17 ms with a 4 ms one."""
    S = trace.Span
    return [S("fdtpu/train/step", 0, 6 * MS, None, 0), S("fdtpu/graph/replay", MS, 6 * MS, 0, 0),
            S("fdtpu/train/step", 10 * MS, 17 * MS, None, 1),
            S("fdtpu/graph/replay", 12 * MS, 16 * MS, 2, 1)]


READERS = {  # metric -> (mode, records, counters, value)
    "predict_host_ms.stream": ("stream", stream_records, {}, 3.0),
    "predict_lead_ms.stream": ("stream", stream_records, {}, 2.0),
    "graph_captures.stream": ("stream", stream_records, {"graph_captures": 1}, 500.0),
    "step_host_ms.train": ("train", train_records, {}, 2.0),
    "launch_ms.train": ("train", train_records, {}, 4.5),
    "graph_captures.train": ("train", train_records, {}, 0.0),
}


def context(mode, units=2, busy_s=0.5):
    return {"mode": mode, "units": units,
            "window": types.SimpleNamespace(busy_s=busy_s, window_s=1.0)}


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_arithmetic(metric, monkeypatch):
    mode, made, counts, value = READERS[metric]
    monkeypatch.setattr(trace, "records", made)
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    read = reader(metric)
    assert read(context(mode)) == pytest.approx(value)
    assert read(context(mode, busy_s=0.0)) is None  # no device work traced
    assert read(context(mode, units=3)) is None  # a span a unit, or nothing
    assert read(context("train" if mode == "stream" else "stream")) is None
    monkeypatch.setattr(trace, "records", list)
    assert read(context(mode)) is None  # a program that kept no spans


@pytest.mark.parametrize("metric", ["predict_lead_ms.stream", "step_host_ms.train",
                                    "launch_ms.train"])
def test_reader_needs_each_units_replay(metric, monkeypatch):
    mode, made, _, _ = READERS[metric]
    held = [s for s in made() if not (s.name == "fdtpu/graph/replay" and s.unit == 1)]
    monkeypatch.setattr(trace, "records", lambda: held)
    assert reader(metric)(context(mode)) is None


# -- on a card ----------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_predict_capture_and_replay_spans(card):
    torch.manual_seed(0)
    det = Detector(PoolResnet(8, SIZE, 5, 2).to(card), nms_capacity=16)
    with profile(activities=[ProfilerActivity.CPU]):
        det.predict(frame())  # the capture, inside the staging
    held = trace.records()
    captures = [s for s in held if s.name == "fdtpu/graph/capture"]
    assert len(captures) == 1 and held[captures[0].parent].name == "fdtpu/predict/stage"
    assert trace.counters() == {"graph_captures": 1}
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for seed in (1, 2, 3):
            det.predict(frame(seed))
    held = trace.records()
    assert trace.counters() == {}
    for unit in (1, 2, 3):
        spans = [s for s in held if s.unit == unit]
        assert sorted(s.name for s in spans) == sorted(PREDICT)
        top = held.index(next(s for s in spans if s.name == "fdtpu/predict"))
        assert all(s.parent == top for s in spans if s.name != "fdtpu/predict")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["poolresnet128-train-b8-480", "poolresnet128-stream-b1-480"])
def test_card_traced_cell_reports_the_new_metrics(name, card, tmp_path):
    """A tiny traced run of a cell on the card: a resident epoch's steps
    each a ``fdtpu/train/step`` span with one replay, a stream's frames each
    a ``fdtpu/predict`` span; no capture in the window; every new reader
    reads."""
    from perfbench import cell
    from perfbench.tests import tiny

    out = cell.run(tiny.spec(name), 2**40 + 7, 0.3, True, card, time.perf_counter(), tmp_path)
    held = trace.records()
    top = "fdtpu/train/step" if "train" in name else "fdtpu/predict"
    units = [i for i, s in enumerate(held) if s.name == top]
    assert len(units) == out["attempted"] > 0
    for i in units:
        assert sum(s.parent == i and s.name == "fdtpu/graph/replay" for s in held) == 1
    mode = "train" if "train" in name else "stream"
    for metric in (m for m in READERS if m.endswith(mode)):
        assert metric in out["metrics"], metric
    assert out["metrics"][f"graph_captures.{mode}"]["value"] == 0
