"""Dispatch amortization: the port's ``steps_per_dispatch`` (the streamed driver's
groups) against fdtpu's ``ScanDispatchDriver``, and the pieces of the captured train
step that run on the CPU.

The Trainer comparison keeps ``tests/test_torch_trainer.py``'s setup (160 px,
16 filters, 2 blocks, float32, augmentation off, dropout 0, fdtpu's initial
params converted, shuffle off, SGD at lr 1e-2 with and without SAM) at batch
2 over 8 synthetic images, so an epoch has 4 batches: at k = 3 one full group
and the metrics batch, as in fdtpu's own k-against-1 test
(``tests/test_train.py``). Tolerances as there: epoch loss and metrics rtol
1e-4, final params atol 1e-5, equal step counts; the group log lines name the
same steps, their losses within the same rtol (a line prints four decimals).
On the CPU the port's streamed driver runs the eager step, so its k = 3 equals
its k = 1 bit for bit.

The group boundaries are held against fdtpu's drivers themselves (its
``ScanDispatchDriver`` for k > 1, its ``StreamedDriver`` for k = 1), run with
steps that record the batches they get (no compile): the same batches in the
same order through the train step, the same batch to the metrics step, the
same log lines. The CUDA graph itself runs on the card only (``chip_smoke.py``
phases 17a, 19a and 21); here ``CapturedTrainStep`` refuses the CPU, a step
with metrics, a gloo group and a set ``halo.timer``, takes a data-parallel or
spatial step over an NCCL group (a one-rank gloo group reporting NCCL stands
in), and the optimizer's capturable form (its rate a tensor, its step counts
where the params are) goes through the schedule and a checkpoint. Under
``nan_check`` the port's fit at k = 3 is held against fdtpu's as above;
``parallel.trainer_route`` against fdtpu's ``Trainer._use_shardmap``.
"""

import ast
import contextlib
import dataclasses
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch
import torch.distributed as dist

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.data.pipeline import Batch as JaxBatch
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.train.drivers import ScanDispatchDriver as JaxScanDispatchDriver
from fdtpu.train.drivers import StreamedDriver as JaxStreamedDriver
from fdtpu.train import loop as jax_loop
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch import train_model
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.data.pipeline import Batch
from fdtpu_torch.parallel import halo, make_dp_train_step, make_mesh, trainer_route
from fdtpu_torch.train import CapturedTrainStep, Trainer, create_train_state, make_train_step
from fdtpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from fdtpu_torch.train.drivers import StreamedDriver
from fdtpu_torch.train.graphs import step_groups
from fdtpu_torch.train.state import init_optimizer_state, make_lr_schedule, make_optimizer
from fdtpu_torch.utils.config import TrainConfig
from test_torch_trainer import NMS, PARAMS_ATOL, RTOL, SIZE, jax_model, torch_model

REPO = Path(__file__).resolve().parents[1]
BATCH = 2
LINE = re.compile(r"epoch (\d+) step (\d+): step_loss=([-\d.]+)")


def loader(root, source_cls, loader_cls, parse, **extra):
    src = source_cls(parse(root, "train", 3), SIZE, box_capacity=4, error_log=None, **extra)
    return loader_cls(src, BATCH, drop_last=True)


def config_kw(use_sam, k, tmp, name):
    return dict(optimizer="sgd", learning_rate=1e-2, use_sam=use_sam, max_epochs=2,
                batch_size=BATCH, box_capacity=4, visualize_first_batch=False,
                checkpoint_dir=str(tmp / "ckpt"), log_path=str(tmp / f"logs_{name}" / "out.log"),
                log_every_steps=3, steps_per_dispatch=k)


def fit(trainer):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = trainer.fit()
    return metrics["train"], LINE.findall(out.getvalue())


@pytest.fixture(scope="module", params=[True, False], ids=["sam", "no-sam"])
def runs(request, tmp_path_factory):
    """fdtpu's Trainer and the port's at k = 1 and k = 3, two epochs each
    from the same params: ``{(side, k): (trainer, train metrics, log lines)}``."""
    use_sam = request.param
    tmp = tmp_path_factory.mktemp("sam" if use_sam else "nosam")
    jax_make_synthetic(tmp / "fdtpu_data", 8, split="train", seed=0)
    make_synthetic_widerface(tmp / "port_data", 8, split="train", seed=0)
    out = {}
    for k in (1, 3):
        jt = JaxTrainer(
            jax_model(), JaxTrainConfig(**config_kw(use_sam, k, tmp, f"fdtpu{k}")),
            loader(tmp / "fdtpu_data", JaxSource, JaxBatchLoader, jax_load_targets,
                   use_native=False),
            None, augment=False, nms_params=NMS, run_name=f"fdtpu{k}")
        start = poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params))
        module = torch_model()
        module.load_state_dict(start)
        tt = Trainer(module, TrainConfig(**config_kw(use_sam, k, tmp, f"port{k}")),
                     loader(tmp / "port_data", WIDERFaceDataSource, BatchLoader, load_targets,
                            use_native=False),
                     None, augment=False, nms_params=NMS, run_name=f"port{k}", device="cpu")
        out["fdtpu", k] = (jt, *fit(jt))
        out["port", k] = (tt, *fit(tt))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_epoch_metrics_match_fdtpu(runs, k):
    (_, got, _), (_, want, _) = runs["port", k], runs["fdtpu", k]
    assert set(want) == {"loss", "iou", "recall", "precision", "f1"}
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("k", [1, 3])
def test_final_params_and_steps_match_fdtpu(runs, k):
    (tt, _, _), (jt, _, _) = runs["port", k], runs["fdtpu", k]
    assert type(tt.driver).__name__ == "StreamedDriver"
    assert type(jt.driver).__name__ == ("ScanDispatchDriver" if k > 1 else "StreamedDriver")
    assert tt.state.step == int(jt.state.step) == 8
    want = poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params))
    for name, p in tt.state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAMS_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("k", [1, 3])
def test_group_log_lines_match_fdtpu(runs, k):
    """k = 3: one line a group, at the group's last step (2), the metrics
    batch after it; k = 1: one line every 3 steps (0 and 3)."""
    got, want = runs["port", k][2], runs["fdtpu", k][2]
    assert [line[:2] for line in got] == [line[:2] for line in want]
    assert [s for _, s, _ in got] == (["2", "2"] if k == 3 else ["0", "3", "0", "3"])
    np.testing.assert_allclose([float(v) for *_, v in got], [float(v) for *_, v in want],
                               rtol=RTOL, atol=1e-4)


def test_k3_equals_k1_bit_for_bit(runs):
    (t1, m1, _), (t3, m3, _) = runs["port", 1], runs["port", 3]
    assert m1 == m3 and t1.state.step == t3.state.step
    for p, q in zip(t1.state.module.parameters(), t3.state.module.parameters()):
        assert torch.equal(p, q)


def test_k3_equals_k1_with_augmentation(tmp_path):
    """The default step (augmentation, dropout, SAM + Adam) at k = 3 and
    k = 1 on the CPU: the same epochs bit for bit."""
    make_synthetic_widerface(tmp_path / "data", 8, split="train", seed=0)
    fits = {}
    for k in (1, 3):
        torch.manual_seed(0)
        module = torch_model()
        src = WIDERFaceDataSource(load_targets(tmp_path / "data", "train", 3), SIZE,
                                  box_capacity=4, error_log=None)
        cfg = TrainConfig(max_epochs=2, batch_size=BATCH, box_capacity=4, log_every_steps=0,
                          visualize_first_batch=False, steps_per_dispatch=k,
                          checkpoint_dir=str(tmp_path / f"ckpt{k}"),
                          log_path=str(tmp_path / f"logs{k}" / "out.log"))
        t = Trainer(module, cfg, BatchLoader(src, BATCH, shuffle=True, drop_last=True), None,
                    nms_params=NMS, run_name="aug", device="cpu")
        fits[k] = (t.fit()["train"], t)
    (m1, t1), (m3, t3) = fits[1], fits[3]
    assert m1 == m3 and t1.state.step == t3.state.step == 8
    for p, q in zip(t1.state.module.parameters(), t3.state.module.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(t1.state.module.parameters(), t3.state.module.parameters()):
        s1, s3 = t1.state.optimizer.state[p], t3.state.optimizer.state[q]
        assert set(s1) == set(s3) and all(torch.equal(s1[key], s3[key]) for key in s1)


# -- group boundaries against fdtpu's driver, with recording steps ---------------------


class Loader:
    """``n`` batches of 2 one-pixel frames; each frame holds its batch's index."""

    def __init__(self, n, batch_cls):
        self.n, self.batch_cls, self.batch_size = n, batch_cls, 2

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self.batch_cls(np.full((2, 1, 1, 3), i, np.uint8), np.zeros((2, 1, 5), np.float32),
                                 np.zeros((2, 1), bool), np.ones((2,), bool))


class Logger:
    def log_epoch(self, epoch, split, metrics):
        pass


def record(n, k, train_metrics, port: bool):
    """Drive one epoch of the streamed driver (fdtpu's: its
    ``ScanDispatchDriver`` for k > 1) over ``n`` batches with steps that
    record which batches they get: ``(calls, log lines, metrics)``, a call
    ``(kind, [batch indices])``."""
    calls = []

    def scalars(loss, metrics=True):
        """A step's scalars: the detection metrics from the metrics step alone."""
        return ({"loss": loss, "iou": 0.5 * loss, "recall": loss, "precision": loss} if metrics
                else {"loss": loss})

    def idx(images):
        return int(np.asarray(images)[0, 0, 0, 0])

    if port:
        def train_step(state, images, *rest):
            calls.append(("step", [idx(images)]))
            return state, scalars(torch.tensor(float(idx(images))), metrics=False)

        def metrics_step(state, images, *rest):
            calls.append(("metrics", [idx(images)]))
            return state, scalars(torch.tensor(float(idx(images))))

        t = type("T", (), {})()
        t.primary, t.device = True, torch.device("cpu")
        t.runner = lambda slot: metrics_step if slot == "metrics" else train_step  # eager
        driver = StreamedDriver(t)
    else:
        def train_step(state, images, *rest):
            calls.append(("step", [idx(images)]))
            return state, scalars(jnp.float32(idx(images)), metrics=False)

        def metrics_step(state, images, *rest):
            calls.append(("metrics", [idx(images)]))
            return state, scalars(jnp.float32(idx(images)))

        def scan(m):
            def run(state, rng, *flat):
                ids = [idx(flat[4 * j]) for j in range(m)]
                calls.append(("group", ids))
                return state, jnp.asarray(ids, jnp.float32)
            return run

        t = type("T", (), {})()
        t.rng, t.mesh, t._can_visualize = None, None, lambda images: False
        if k > 1:
            driver = JaxScanDispatchDriver.__new__(JaxScanDispatchDriver)
            driver._scan_train_step = scan
        else:
            driver = JaxStreamedDriver.__new__(JaxStreamedDriver)
        driver.t = t
    t.state, t.epoch, t.logger = None, 0, Logger()
    t.train_step, t._metrics_train_step = train_step, lambda: metrics_step
    t.train_loader = Loader(n, Batch if port else JaxBatch)
    t.config = type("C", (), dict(steps_per_dispatch=k, train_metrics=train_metrics,
                                  log_every_steps=k, visualize_first_batch=False))()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = driver.train_epoch()
    return calls, out.getvalue().splitlines(), metrics


@pytest.mark.parametrize("n,k,train_metrics", [
    (4, 3, True), (8, 3, True), (8, 3, False), (7, 4, True), (9, 4, False), (1, 3, True),
    (2, 3, False), (6, 2, True), (4, 1, True), (5, 1, False), (1, 1, True)])
def test_group_boundaries_match_fdtpu(n, k, train_metrics):
    got, got_lines, got_metrics = record(n, k, train_metrics, port=True)
    want, want_lines, want_metrics = record(n, k, train_metrics, port=False)
    steps = [i for kind, ids in want if kind in ("group", "step") for i in ids]
    assert [i for kind, ids in got if kind == "step" for i in ids] == steps
    assert [c for c in got if c[0] == "metrics"] == [c for c in want if c[0] == "metrics"]
    assert got_lines == want_lines
    assert got_metrics == pytest.approx(want_metrics)
    if train_metrics:
        assert want[-1] == ("metrics", [n - 1])
    groups = [len(ids) for kind, ids in want if kind in ("group", "step")]
    assert all(g == k for g in groups[:-1]) and all(0 < g <= k for g in groups[-1:])
    assert sum(groups) == n - (1 if train_metrics else 0)


# -- the captured step's refusals --------------------------------------------------


def small_state(optimizer="adam"):
    torch.manual_seed(0)
    cfg = TrainConfig(optimizer=optimizer, lr_milestones=(1, 3), learning_rate=1e-3)
    return create_train_state(torch_model(), cfg, steps_per_epoch=4), cfg


def test_captured_step_on_the_cpu_raises():
    state, cfg = small_state()
    captured = CapturedTrainStep(make_train_step(state.module, cfg))
    batch = (torch.zeros((2, *SIZE, 3), dtype=torch.uint8), torch.zeros((2, 4, 5)),
             torch.zeros((2, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="needs a card"):
        captured(state, *batch)
    assert state.step == 0 and not captured.graphs


@pytest.fixture
def gloo_world(tmp_path):
    """A one-rank gloo process group, the default group, for the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def nccl_backend(monkeypatch):
    """Every group reports NCCL (the CPU has none: a gloo group stands in)."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")


@pytest.mark.parametrize("what", ["compute_metrics", "group", "mesh", "timer"])
def test_captured_step_refuses_metrics_group_and_mesh(what, gloo_world, monkeypatch):
    """A data-parallel or spatial step over a gloo group (its collectives
    run on the host) and any step while ``parallel.halo.timer`` is set (it
    synchronises the card) are refused at construction; a timer set after
    construction is refused at the capture. A step with metrics (K1's
    decode and the metrics are device ops) is taken like any other: here
    the CPU refuses its graph at its first call."""
    state, cfg = small_state()
    match = {"group": "gloo", "mesh": "gloo", "timer": "halo.timer"}.get(what)
    if what == "compute_metrics":
        captured = CapturedTrainStep(make_train_step(state.module, cfg, compute_metrics=True))
        batch = (torch.zeros((2, *SIZE, 3), dtype=torch.uint8), torch.zeros((2, 4, 5)),
                 torch.zeros((2, 4), dtype=torch.bool))
        with pytest.raises(ValueError, match="needs a card"):
            captured(state, *batch)
        assert state.step == 0 and not captured.graphs
        return
    if what == "group":
        step = make_dp_train_step(state.module, cfg, group=gloo_world)
    elif what == "mesh":
        step = make_dp_train_step(state.module, cfg, mesh=make_mesh(1, 1))
    else:
        step = make_train_step(state.module, cfg)
        captured = CapturedTrainStep(step)
        monkeypatch.setattr(halo, "timer", {})
        with pytest.raises(ValueError, match=match):
            captured._capture(state, None, None, None)
    with pytest.raises(ValueError, match=match):
        CapturedTrainStep(step)


@pytest.mark.parametrize("what", ["group", "mesh"])
def test_captured_step_takes_an_nccl_group_and_mesh(what, gloo_world, monkeypatch):
    """A data-parallel step over an NCCL group, and a spatial step over an
    NCCL mesh, are captured with their collectives; here the CPU refuses
    the graph at its first call, as for the one-process step."""
    nccl_backend(monkeypatch)
    state, cfg = small_state()
    if what == "group":
        step = make_dp_train_step(state.module, cfg, group=gloo_world)
    else:
        step = make_dp_train_step(state.module, cfg, mesh=make_mesh(1, 1))
    captured = CapturedTrainStep(step)
    assert captured.rank == 0 and step_groups(step)[0] is gloo_world
    batch = (torch.zeros((2, *SIZE, 3), dtype=torch.uint8), torch.zeros((2, 4, 5)),
             torch.zeros((2, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="needs a card"):
        captured(state, *batch)


def trainer_args(tmp_path):
    make_synthetic_widerface(tmp_path / "data", 4, split="train", seed=0)
    src = WIDERFaceDataSource(load_targets(tmp_path / "data", "train", 3), SIZE, box_capacity=4,
                              error_log=None)
    return torch_model(), BatchLoader(src, BATCH)


@pytest.fixture(scope="module")
def nan_check_fits(tmp_path_factory):
    """fdtpu's Trainer and the port's at k = 3 under ``nan_check``, without
    SAM, as ``runs`` builds them: ``{side: (trainer, train metrics, log
    lines)}``, the port's params after the fit, and the error of a port
    epoch from NaN params; both checks
    are off again before any test runs."""
    tmp = tmp_path_factory.mktemp("nan_check")
    jax_make_synthetic(tmp / "fdtpu_data", 8, split="train", seed=0)
    make_synthetic_widerface(tmp / "port_data", 8, split="train", seed=0)
    try:
        jt = JaxTrainer(
            jax_model(), JaxTrainConfig(**config_kw(False, 3, tmp, "fdtpu"), nan_check=True),
            loader(tmp / "fdtpu_data", JaxSource, JaxBatchLoader, jax_load_targets,
                   use_native=False),
            None, augment=False, nms_params=NMS, run_name="fdtpu")
        assert jax.config.jax_debug_nans
        module = torch_model()
        module.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params)))
        tt = Trainer(module, TrainConfig(**config_kw(False, 3, tmp, "port"), nan_check=True),
                     loader(tmp / "port_data", WIDERFaceDataSource, BatchLoader, load_targets,
                            use_native=False),
                     None, augment=False, nms_params=NMS, run_name="port", device="cpu")
        assert torch.is_anomaly_enabled()
        out = {"fdtpu": (jt, *fit(jt)), "port": (tt, *fit(tt))}
        out["params"] = {n: p.detach().clone() for n, p in tt.state.module.named_parameters()}
        # a NaN in the params: anomaly mode stops the first backward that returns one
        with torch.no_grad():
            next(tt.state.module.parameters()).fill_(float("nan"))
        try:
            tt.train_epoch()
        except RuntimeError as e:
            out["nan"] = str(e)
    finally:
        jax.config.update("jax_debug_nans", False)
        torch.autograd.set_detect_anomaly(False)
    return out


def test_dispatch_with_nan_check_raises(nan_check_fits):
    """fdtpu trains ``steps_per_dispatch`` > 1 under ``nan_check``; so does
    the port, with its eager step under anomaly mode at fdtpu's group
    cadence: at k = 3 the epoch metrics, the params, the steps and the group
    log lines match fdtpu's (``runs``' tolerances), no replay runs, and a
    NaN in a backward raises."""
    (tt, got, got_lines), (jt, want, want_lines) = (nan_check_fits[side]
                                                    for side in ("port", "fdtpu"))
    assert not tt.replaying and not tt.captured
    assert type(jt.driver).__name__ == "ScanDispatchDriver"
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-7, err_msg=key)
    assert tt.state.step == int(jt.state.step) == 8
    ref = poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params))
    for name, p in nan_check_fits["params"].items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=PARAMS_ATOL, rtol=0,
                                   err_msg=name)
    assert [line[:2] for line in got_lines] == [line[:2] for line in want_lines]
    assert [s for _, s, _ in got_lines] == ["2", "2"]
    np.testing.assert_allclose([float(v) for *_, v in got_lines],
                               [float(v) for *_, v in want_lines], rtol=RTOL, atol=1e-4)
    assert "nan" in nan_check_fits.get("nan", "").lower(), "no NaN was caught"


def test_dispatch_with_a_data_parallel_group_raises(tmp_path, gloo_world, monkeypatch):
    """fdtpu scans the data-parallel step; so does the port's Trainer, at
    k = 2 on fdtpu's shard_map route. It replays only on a card, without
    ``nan_check``, over no group or an NCCL one (``Trainer.replays``); over
    a gloo group its eager step runs, and a capture of that step raises."""
    module, loader_ = trainer_args(tmp_path)
    monkeypatch.setattr(Trainer, "_data_parallel_group", staticmethod(lambda *a: gloo_world))
    cfg = TrainConfig(steps_per_dispatch=2, log_path=str(tmp_path / "l.log"))
    trainer = Trainer(module, cfg, loader_, device="cpu")
    assert trainer.group is gloo_world and trainer.route == "shard_map"
    assert trainer.train_step.group is gloo_world and not trainer.replaying
    assert trainer.state.optimizer.param_groups[0]["capturable"] is False
    with pytest.raises(ValueError, match="gloo"):
        CapturedTrainStep(trainer.train_step)
    card = torch.device("cuda")
    replays = {(dev.type, group is not None, nan): Trainer.replays(
        dev, dataclasses.replace(cfg, nan_check=nan), group)
        for dev in (card, torch.device("cpu")) for group in (None, gloo_world)
        for nan in (False, True)}
    assert [k for k, v in replays.items() if v] == [("cuda", False, False)]  # gloo: eager
    nccl_backend(monkeypatch)
    assert Trainer.replays(card, cfg, gloo_world)
    assert not Trainer.replays(card, dataclasses.replace(cfg, nan_check=True), gloo_world)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("device_data", [False, True])
@pytest.mark.parametrize("rotate", [False, True])
def test_trainer_route_matches_fdtpu(tmp_path, monkeypatch, rotate, device_data, k):
    """``parallel.trainer_route`` against fdtpu's ``Trainer._use_shardmap``
    on a 2-device mesh (fdtpu's Trainer built without its state)."""
    monkeypatch.setattr(jax_loop, "create_train_state", lambda *a, **kw: (None, None))
    kw = dict(rotate_device=rotate, device_data=device_data, steps_per_dispatch=k)
    jt = JaxTrainer(jax_model(), JaxTrainConfig(data_parallel=2, log_path=str(tmp_path / "l.log"),
                                                **kw), Loader(2, JaxBatch))
    assert jt.mesh is not None
    assert trainer_route(TrainConfig(**kw)) == ("shard_map" if jt._use_shardmap else "gspmd")


def test_steps_per_dispatch_below_one_raises():
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        TrainConfig(steps_per_dispatch=0)


def test_adam_is_capturable_only_where_a_graph_replays(tmp_path):
    """A state is built with a plain Adam unless asked (bench's eager rows,
    the gloo ranks' states); the Trainer asks only where it replays, on a
    card: on the CPU it holds no captured step and a plain Adam, whatever
    k."""
    state, _ = small_state()
    assert state.optimizer.param_groups[0]["capturable"] is False
    assert isinstance(state.optimizer.param_groups[0]["lr"], float)
    module, loader_ = trainer_args(tmp_path)
    for k in (1, 3):
        cfg = TrainConfig(steps_per_dispatch=k, log_path=str(tmp_path / f"l{k}.log"))
        trainer = Trainer(module, cfg, loader_, device="cpu")
        assert not trainer.replaying and not trainer.captured
        assert trainer.state.optimizer.param_groups[0]["capturable"] is False


# -- the capturable optimizer: rate and checkpoint ------------------------------------


def test_lr_tensor_follows_the_schedule_across_milestones():
    """The step's prologue fills a capturable Adam's rate tensor (built on
    the CPU here by asking for it) with ``make_lr_schedule``'s float32 value
    at every step, across both milestones."""
    state, cfg = small_state()
    state.optimizer = make_optimizer(cfg, list(state.module.parameters()), capturable=True)
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32 and lr.dim() == 0
    schedule = make_lr_schedule(cfg, 4)
    step = make_train_step(state.module, cfg)
    seen = set()
    for s in range(20):
        state.step = s
        step.prologue(state)
        assert state.optimizer.param_groups[0]["lr"] is lr
        assert lr.item() == np.float32(schedule(s)), s
        seen.add(lr.item())
    assert len(seen) == 3  # 1e-3, 1e-4, 1e-5
    plain, _ = small_state()
    step.prologue(plain)
    assert plain.optimizer.param_groups[0]["lr"] == schedule(0)  # a float on the CPU


def test_checkpoint_round_trips_a_capturable_adam(tmp_path):
    """A CPU Adam's state after a step, saved, restored into a capturable
    Adam whose state already exists (as a captured graph holds it): the
    values land in the template's own tensors, the step counts stay float32
    where the template keeps them, the rate stays the template's tensor;
    saved again and restored into a plain Adam, the state is the first."""
    state, cfg = small_state()
    batch = (torch.randint(0, 255, (2, *SIZE, 3), dtype=torch.uint8),
             torch.tensor([[[1.0, 40, 50, 60, 40]] * 4] * 2), torch.ones((2, 4), dtype=bool))
    state, _ = make_train_step(state.module, cfg)(state, *batch)
    first = save_checkpoint(tmp_path / "a", state)

    template, _ = small_state()
    template.optimizer = make_optimizer(cfg, list(template.module.parameters()), capturable=True)
    init_optimizer_state(template.optimizer)
    lr = template.optimizer.param_groups[0]["lr"]
    held = {p: dict(s) for p, s in template.optimizer.state.items()}
    restore_checkpoint(first, template)
    assert template.step == state.step == 1
    assert template.optimizer.param_groups[0]["lr"] is lr
    assert template.optimizer.param_groups[0]["capturable"] is True
    for p, q in zip(template.module.parameters(), state.module.parameters()):
        assert torch.equal(p, q)
        got, want = template.optimizer.state[p], state.optimizer.state[q]
        assert set(got) == set(want) == {"step", "exp_avg", "exp_avg_sq"}
        for key in got:
            assert got[key] is held[p][key]  # in place
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key])
    ckpt = torch.load(save_checkpoint(tmp_path / "b", template), weights_only=True)
    assert isinstance(ckpt["optimizer"]["param_groups"][0]["lr"], float)

    plain, _ = small_state()
    restore_checkpoint(tmp_path / "b" / "step_00000001.pt", plain)
    assert plain.optimizer.param_groups[0]["capturable"] is False
    for p, q in zip(plain.module.parameters(), state.module.parameters()):
        got, want = plain.optimizer.state[p], state.optimizer.state[q]
        assert got["step"].device.type == "cpu"
        assert all(torch.equal(got[key], want[key]) for key in want)


# -- the entry point's flag ---------------------------------------------------------


def reference_flag(script: str, flag: str):
    """The ``type`` and ``default`` of ``flag`` in a root script, from its source."""
    tree = ast.parse((REPO / script).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                and node.args and getattr(node.args[0], "value", None) == flag):
            kw = {k.arg: k.value for k in node.keywords}
            return kw["type"].id, ast.literal_eval(kw["default"])
    raise AssertionError(f"{script} has no {flag}")


def test_train_model_parses_steps_per_dispatch_as_fdtpu(tmp_path, monkeypatch):
    """``--steps-per-dispatch`` as ``train_model.py:56`` has it (an int,
    default 1), carried into the Trainer: one epoch at k = 3 writes the
    checkpoint one at k = 1 writes, bit for bit."""
    kind, default = reference_flag("train_model.py", "--steps-per-dispatch")
    assert (kind, default) == ("int", 1)
    assert train_model.parse_args([]).steps_per_dispatch == default
    assert train_model.parse_args(["--steps-per-dispatch", "3"]).steps_per_dispatch == 3
    make_synthetic_widerface(tmp_path / "data", 8, split="train", seed=0)
    make_synthetic_widerface(tmp_path / "data", 4, split="val", seed=1)
    small = ["--data-dir", "data", "--epochs", "1", "--batch-size", "2", "--input", "160",
             "--patches", "5", "--filters", "8", "--blocks", "2", "--device", "cpu"]
    ckpts = {}
    for k in (1, 3):
        work = tmp_path / f"k{k}"
        work.mkdir()
        (work / "data").symlink_to(tmp_path / "data")
        monkeypatch.chdir(work)
        args = train_model.parse_args([*small, "--steps-per-dispatch", str(k)])
        trainer = train_model.build_trainer(args)
        assert trainer.config.steps_per_dispatch == k
        assert type(trainer.driver).__name__ == "StreamedDriver"
        ckpts[k] = torch.load(train_model.main([*small, "--steps-per-dispatch", str(k)]),
                              weights_only=True)
    assert ckpts[1]["step"] == ckpts[3]["step"] == 4
    for name, v in ckpts[1]["module"].items():
        assert torch.equal(v, ckpts[3]["module"][name]), name


def test_train_model_ssd_parses_steps_per_dispatch_as_fdtpu():
    from fdtpu_torch import train_model_ssd

    kind, default = reference_flag("train_model_ssd.py", "--steps-per-dispatch")
    args = train_model_ssd.parse_args(["--steps-per-dispatch", "4"])
    assert (kind, default) == ("int", 1) and args.steps_per_dispatch == 4
    assert train_model_ssd.parse_args([]).steps_per_dispatch == default
