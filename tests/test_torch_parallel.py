"""The port's data parallelism on the CPU: two gloo ranks, each a process
that imports no JAX (``tests/torch_parallel_ranks.py``, with a ``file://``
rendezvous under the test's temporary directory), against fdtpu's
shard_map steps on a 2-device CPU mesh and against the port's
single-process step on the global batch, from the same converted params on
the same numpy batches.

Float32, augmentation and dropout off, SAM + SGD at lr 1e-2. Tolerances:

* PoolResnet (160 px, 8 filters, 2 blocks; one padded sample, so the ranks
  weigh 2 and 1): ``tests/test_torch_train.py``'s f32 step, loss rtol
  1e-5, grad norm rtol 1e-4, params atol 1e-6;
* SSD (64 px, 4 filters) with 4 and 1 positives on the two ranks and one
  padded sample: ``tests/test_torch_ssd.py``'s step, loss and grad norm
  rtol 1e-5, params rtol 1e-4 with atol 1e-7;
* MobileNetV3 (96 px, SGD without SAM): the running statistics against
  fdtpu's pmean'd ``batch_stats``, rtol 1e-5 with atol 1e-7
  (``tests/test_torch_zoo.py``);
* the eval step (the forward is each side's own): loss and metrics rtol
  1e-5;
* the ranks against each other: bit-equal;
* the Trainer: streamed and resident bit-equal; against fdtpu's
  ``data_parallel=2`` Trainer for one epoch, metrics rtol 1e-4 and params
  atol 1e-5 (``tests/test_torch_trainer.py``); at ``steps_per_dispatch=2``
  (fdtpu's shard_map route and its scan inside ``shard_map``), streamed and
  resident, the same tolerances and the same step lines, and within the
  ranks k = 2 = k = 1 bit for bit (on the CPU the ranks run the eager step).
"""

import contextlib
import io
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.parallel import (
    make_mesh,
    make_shardmap_dp_eval_step,
    make_shardmap_dp_train_step,
    shard_batch_arrays,
)
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.train import loop as jax_loop
from fdtpu.train.state import TrainState as JaxTrainState
from fdtpu.train.state import make_optimizer as jax_make_optimizer
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import state_dict_from_fdtpu
from fdtpu_torch.data import BatchLoader, make_synthetic_widerface
from fdtpu_torch.models import SSD, MobileNetV3Backbone, PoolResnet
from fdtpu_torch.parallel import grad_all_reduce, initialize_multihost
from fdtpu_torch.train import create_train_state, make_eval_step, make_train_step
from fdtpu_torch.utils.config import TrainConfig

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_parallel_ranks.py"
WORLD = 2
RANK_TIMEOUT_S = 60
STEP_CONFIG = dict(optimizer="sgd", learning_rate=1e-2, use_sam=True)
POOL = dict(filters=8, input_shape=(160, 160), num_patches=5, num_residual_blocks=2,
            dropout=0.0, head_dropout=0.0)
SSD_SIZE, SSD_PS = (64, 64), (8, 4, 2, 1)
SSD_CTOR = dict(filters=4, input_shape=SSD_SIZE, patch_sizes=SSD_PS, dropout=0.0)
MNV3 = dict(input_shape=(96, 96), num_patches=3)
NMS = (0.05, 0.5, 64)  # a low threshold: the fresh model's boxes reach the metrics
DISPATCH_IMAGES = 12  # the k = 2 fits: three steps, a group of two and the metrics step
DISPATCH_LOG_EVERY = 2  # a step line every log_every_steps // k = 1 groups
LINE = re.compile(r"epoch (\d+) step (\d+): step_loss=([-\d.]+)")


def rank_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    return env


def outputs(procs, timeout: float, kill=subprocess.Popen.kill) -> list[str]:
    """What each process printed, each waited for up to ``timeout``
    seconds in turn. On a timeout every process still running is ended
    (``kill``) and the assertion carries all that each printed; any other
    failure ends them too."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                kill(p)
        logs += [p.communicate()[0] for p in procs[len(logs):]]  # nothing printed is lost
        shown = "\n".join(f"--- process {i}, exit {p.returncode} ---\n{log}"
                          for i, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"a process outran its {timeout} s:\n{shown}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                kill(p)
                p.wait()
    return logs


def run_ranks(task: str, work: Path) -> list[dict]:
    """Both ranks of ``task``; each must exit 0 within the timeout."""
    init = f"file://{work / ('rendezvous_' + task)}"
    procs = [subprocess.Popen([sys.executable, str(RANKS), task, str(r), str(WORLD), init,
                               str(work)], cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = outputs(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(work / f"{task}_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def run_entry(args: list[str], cwd: Path) -> subprocess.CompletedProcess:
    """``python <args>`` in its own session, so that on a timeout the ranks
    it started die with it."""
    proc = subprocess.Popen([sys.executable, *args], cwd=cwd, env=rank_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    (out,) = outputs([proc], RANK_TIMEOUT_S, kill=lambda p: os.killpg(p.pid, signal.SIGKILL))
    return subprocess.CompletedProcess(proc.args, proc.returncode, out)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def grid_batch(size, b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, *size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = rng.uniform(0, size[0] * 0.6, (b, 4, 2)).round()
    boxes[..., 3:5] = rng.uniform(size[0] / 8, size[0] / 3, (b, 4, 2)).round()
    masks = rng.uniform(size=(b, 4)) > 0.3
    masks[:, 0] = True
    sample_mask = np.ones((b,), bool)
    return imgs, boxes, masks, sample_mask


def ssd_batch():
    """Per-image faces 3, 1, 2, 1 with image 2 padded: 4 positive boxes on
    rank 0 and 1 on rank 1."""
    rng = np.random.default_rng(3)
    b = 4
    imgs = rng.integers(0, 256, (b, *SSD_SIZE, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), np.float32)
    masks = np.zeros((b, 4), bool)
    for i, n in enumerate((3, 1, 2, 1)):
        for j in range(n):
            boxes[i, j] = [1.0, 4 + 18 * j, 6 + 14 * j, 16 + 3 * j, 14]
            masks[i, j] = True
    sample_mask = np.array([True, True, False, True])
    return imgs, boxes, masks, sample_mask


def filled_variables(jm, size):
    """fdtpu's variables of ``jm`` (names and shapes from ``jax.eval_shape``
    of its init) filled by numpy: each layer's kernel and bias
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (torch's default init, which
    fdtpu's SSD draws), BatchNorm scales 1, shifts 0 and Flax's initial
    statistics. fdtpu's own init runs op by op and takes up to ~30 s here."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *size, 3)))
    rng = np.random.default_rng(0)

    def fill(tree):
        if "kernel" in tree:
            bound = 1 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
            return {k: jnp.asarray(rng.uniform(-bound, bound, v.shape).astype(np.float32))
                    for k, v in sorted(tree.items())}
        if "scale" in tree:  # a BatchNorm's params
            return {"scale": jnp.ones(tree["scale"].shape), "bias": jnp.zeros(tree["bias"].shape)}
        if "mean" in tree:  # its statistics
            return {"mean": jnp.zeros(tree["mean"].shape), "var": jnp.ones(tree["var"].shape)}
        return {k: fill(v) for k, v in sorted(tree.items())}

    variables = {k: fill(v) for k, v in shapes.items()}
    return variables["params"], variables.get("batch_stats", {})


def jax_state(jm, size, **config):
    """fdtpu's train state of ``jm`` from :func:`filled_variables`."""
    jcfg = JaxTrainConfig(**{**STEP_CONFIG, **config})
    tx = jax_make_optimizer(jcfg, 10)
    params, batch_stats = filled_variables(jm, size)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=batch_stats,
                         opt_state=tx.init(params)), tx, jcfg


MESH = None


def mesh():
    global MESH
    if MESH is None:
        MESH = make_mesh(WORLD)
    return MESH


def fdtpu_dp_step(jm, state, tx, jcfg, batch):
    step = make_shardmap_dp_train_step(jm, tx, jcfg, mesh(), augment=False)
    return step(state, *shard_batch_arrays(mesh(), *batch), jax.random.PRNGKey(5))


def fdtpu_dp_eval(jm, state, jcfg, batch):
    step = make_shardmap_dp_eval_step(jm, jcfg, mesh(), nms_params=NMS)
    return step(state, *shard_batch_arrays(mesh(), *batch))


def port_single_step(module, batch):
    cfg = TrainConfig(**STEP_CONFIG)
    state = create_train_state(module, cfg, 10)
    state, scalars = make_train_step(module, cfg, augment=False)(
        state, *(torch.from_numpy(a) for a in batch))
    return {k: v.item() for k, v in scalars.items()}, module.state_dict()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every case's fdtpu shard_map result, the port's single-process step
    and both ranks' data-parallel steps."""
    work = tmp_path_factory.mktemp("dp_steps")
    cases, fdtpu, single = {}, {}, {}

    jm = JaxPoolResnet(**POOL, dtype=jnp.float32)
    state, tx, jcfg = jax_state(jm, POOL["input_shape"])
    batch = grid_batch((160, 160))
    batch[3][-1] = False  # rank 1 holds one padded sample
    sd = state_dict_from_fdtpu(numpy_tree(state.params), PoolResnet(**POOL))
    cases["poolresnet"] = dict(family="poolresnet", ctor=POOL, state_dict=sd,
                               config=STEP_CONFIG, batch=batch, kind="train")
    cases["poolresnet_eval"] = dict(cases["poolresnet"], kind="eval", nms=NMS)
    fdtpu["poolresnet_eval"] = fdtpu_dp_eval(jm, state, jcfg, batch)
    fdtpu["poolresnet"] = fdtpu_dp_step(jm, state, tx, jcfg, batch)
    module = PoolResnet(**POOL)
    module.load_state_dict(sd)
    single["poolresnet"] = port_single_step(module, batch)

    jssd = JaxSSD(**SSD_CTOR, dtype=jnp.float32)
    state, tx, jcfg = jax_state(jssd, SSD_SIZE)
    batch = ssd_batch()
    sd = state_dict_from_fdtpu(numpy_tree(state.params), SSD(**SSD_CTOR))
    cases["ssd"] = dict(family="ssd", ctor=SSD_CTOR, state_dict=sd, config=STEP_CONFIG,
                        batch=batch, kind="train")
    cases["ssd_eval"] = dict(cases["ssd"], kind="eval", nms=NMS)
    fdtpu["ssd_eval"] = fdtpu_dp_eval(jssd, state, jcfg, batch)
    fdtpu["ssd"] = fdtpu_dp_step(jssd, state, tx, jcfg, batch)
    module = SSD(**SSD_CTOR)
    module.load_state_dict(sd)
    single["ssd"] = port_single_step(module, batch)

    # SAM off: the statistics come from the unperturbed forward either way
    jmn = JaxMobileNetV3(**MNV3, dtype=jnp.float32)
    state, tx, jcfg = jax_state(jmn, MNV3["input_shape"], use_sam=False)
    batch = grid_batch((96, 96), seed=1)
    sd = state_dict_from_fdtpu(numpy_tree(state.params), MobileNetV3Backbone(**MNV3),
                               numpy_tree(state.batch_stats))
    cases["mobilenetv3"] = dict(family="mobilenetv3", ctor=MNV3, state_dict=sd,
                                config=dict(STEP_CONFIG, use_sam=False), batch=batch,
                                kind="train")
    fdtpu["mobilenetv3"] = fdtpu_dp_step(jmn, state, tx, jcfg, batch)

    torch.save({"steps": cases}, work / "inputs.pt")
    ranks = run_ranks("steps", work)
    return {"cases": cases, "fdtpu": fdtpu, "single": single, "ranks": ranks}


def assert_ranks_equal(ranks, name):
    a, b = (r[name] for r in ranks)
    assert a["scalars"] == b["scalars"]
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k


@pytest.mark.parametrize("name, params_tol", [
    ("poolresnet", dict(atol=1e-6, rtol=0)),
    ("ssd", dict(atol=1e-7, rtol=1e-4)),
])
def test_dp_step_matches_fdtpu_and_the_global_batch(steps, name, params_tol):
    """PoolResnet with a padded sample, and the SSD with 4 and 1 positives
    on the two ranks: the 2-rank step equals fdtpu's shard_map step and the
    port's one-process step on the global batch."""
    assert_ranks_equal(steps["ranks"], name)
    got = steps["ranks"][0][name]
    assert got["step"] == 1
    jnew, jsc = steps["fdtpu"][name]
    want = state_dict_from_fdtpu(numpy_tree(jnew.params),
                                 {"poolresnet": PoolResnet, "ssd": SSD}[name](
                                     **steps["cases"][name]["ctor"]))
    single_sc, single_sd = steps["single"][name]
    grad_rtol = 1e-4 if name == "poolresnet" else 1e-5
    for ref_loss, ref_gn, ref_sd in ((float(jsc["loss"]), float(jsc["grad_norm"]), want),
                                    (single_sc["loss"], single_sc["grad_norm"], single_sd)):
        np.testing.assert_allclose(got["scalars"]["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(got["scalars"]["grad_norm"], ref_gn, rtol=grad_rtol)
        start = steps["cases"][name]["state_dict"]
        for k, v in ref_sd.items():
            assert not torch.equal(got["state_dict"][k], start[k]), k  # the step moved it
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), **params_tol,
                                       err_msg=k)


def test_mobilenetv3_running_statistics_match_fdtpu_pmean(steps):
    assert_ranks_equal(steps["ranks"], "mobilenetv3")
    jnew, _ = steps["fdtpu"]["mobilenetv3"]
    got = steps["ranks"][0]["mobilenetv3"]["state_dict"]
    want = state_dict_from_fdtpu(numpy_tree(jnew.params), MobileNetV3Backbone(**MNV3),
                                 numpy_tree(jnew.batch_stats))
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 34
    start = steps["cases"]["mobilenetv3"]["state_dict"]
    for k in names:
        assert not torch.equal(got[k], start[k]), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["poolresnet_eval", "ssd_eval"])
def test_dp_eval_step_matches_fdtpu(steps, name):
    """The reduced loss (YOLO's sum; the SSD's re-weighted by positives)
    and the valid-count-weighted metrics."""
    assert_ranks_equal(steps["ranks"], name)
    got = steps["ranks"][0][name]["scalars"]
    want = steps["fdtpu"][name]
    assert set(got) == {"loss", "iou", "recall", "precision"}
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if name == "poolresnet_eval":
        assert got["iou"] > 0


# -- the Trainer -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """fdtpu's ``data_parallel=2`` Trainer for one epoch (SAM + SGD, shuffle
    off) on its copy of 8 + 8 synthetic images, and the port's two ranks,
    streamed and resident, from fdtpu's initial params; then fdtpu's at
    ``steps_per_dispatch=2`` on 12 + 8 images, with its printed step lines,
    and the port's ranks at k = 1 and 2 there (``torch_parallel_ranks``)."""
    work = tmp_path_factory.mktemp("dp_trainer")
    size = (160, 160)
    kw = dict(STEP_CONFIG, max_epochs=1, batch_size=4, box_capacity=4,
              visualize_first_batch=False, log_every_steps=0)
    for make, name in ((jax_make_synthetic, "fdtpu_data"), (make_synthetic_widerface, "data")):
        make(work / name, 8, split="train", seed=0)
        make(work / name, 8, split="val", seed=1)
        make(work / f"{name}_k", DISPATCH_IMAGES, split="train", seed=2)
        make(work / f"{name}_k", 8, split="val", seed=1)

    def jax_loaders(root):
        srcs = [JaxSource(jax_load_targets(root, split, 3), size, box_capacity=4,
                          error_log=None, use_native=False) for split in ("train", "val")]
        return JaxBatchLoader(srcs[0], 4), JaxBatchLoader(srcs[1], 4)

    def filled_state(module, config, rng, steps_per_epoch):
        tx = jax_make_optimizer(config, steps_per_epoch)
        params, _ = filled_variables(module, size)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                             opt_state=tx.init(params)), tx

    def jax_trainer(root, name, **config):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_loop, "create_train_state", filled_state)
            return JaxTrainer(JaxPoolResnet(**POOL, dtype=jnp.float32),
                              JaxTrainConfig(**{**kw, **config}, data_parallel=WORLD,
                                             checkpoint_dir=str(work / f"jc_{name}"),
                                             log_path=str(work / f"jl_{name}" / "out.log")),
                              *jax_loaders(root), augment=False, nms_params=NMS, run_name=name)

    jt = jax_trainer(work / "fdtpu_data", "fdtpu")
    sd = state_dict_from_fdtpu(numpy_tree(jt.state.params), PoolResnet(**POOL))
    want = jt.fit()
    jk = jax_trainer(work / "fdtpu_data_k", "fdtpu_k", steps_per_dispatch=2,
                     log_every_steps=DISPATCH_LOG_EVERY)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        want_k = jk.fit()
    spec = dict(family="poolresnet", ctor=POOL, state_dict=sd, root=str(work / "data"),
                root_k=str(work / "data_k"), log_every_steps=DISPATCH_LOG_EVERY, size=size,
                batch=4, nms=NMS, work=str(work), config=kw)
    torch.save({"trainer": spec}, work / "inputs.pt")
    return {"fdtpu": (jt, want), "fdtpu_k2": (jk, want_k, printed.getvalue()),
            "ranks": run_ranks("trainer", work)}


def test_dp_trainer_streamed_equals_resident(trainers):
    for rank in trainers["ranks"]:
        streamed, resident = rank["streamed"], rank["resident"]
        assert (streamed["driver"], resident["driver"]) == ("StreamedDriver", "ResidentDriver")
        assert streamed["metrics"] == resident["metrics"]  # every float bit-equal
        assert streamed["step"] == resident["step"] == 2
        for k, v in streamed["state_dict"].items():
            assert torch.equal(v, resident["state_dict"][k]), k
    a, b = trainers["ranks"]
    assert a["streamed"]["metrics"] == b["streamed"]["metrics"]
    for k, v in a["streamed"]["state_dict"].items():
        assert torch.equal(v, b["streamed"]["state_dict"][k]), k  # rank 0's start broadcast
    assert a["streamed"]["ckpt"] == b["streamed"]["ckpt"]


def test_dp_trainer_matches_fdtpu(trainers):
    jt, want = trainers["fdtpu"]
    got = trainers["ranks"][0]["streamed"]
    assert got["step"] == 2
    assert_fit_matches_fdtpu(got, jt, want)
    assert want["val"]["iou"] > 0


def assert_fit_matches_fdtpu(got: dict, jt, want: dict) -> None:
    """Epoch metrics rtol 1e-4, params atol 1e-5, equal step counts."""
    assert int(jt.state.step) == got["step"]
    for split in ("train", "val"):
        assert list(got["metrics"][split]) == list(want[split])
        for k in want[split]:
            np.testing.assert_allclose(got["metrics"][split][k], want[split][k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{split} {k}")
    ref = state_dict_from_fdtpu(numpy_tree(jt.state.params), PoolResnet(**POOL))
    for k, v in ref.items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("feed", ["streamed", "resident"])
def test_dp_trainer_steps_per_dispatch_matches_fdtpu(trainers, feed):
    """fdtpu's ``data_parallel=2, steps_per_dispatch=2`` Trainer (its
    shard_map route; streamed: its ``ScanDispatchDriver`` inside
    ``shard_map``, one scan of two steps and the metrics step) against the
    port's two gloo ranks at k = 2, which take the same route and run their
    eager steps: metrics, params and steps; the streamed feed prints fdtpu's
    step lines (one at each group's end), the resident one none, as fdtpu's
    resident epoch scan."""
    jk, want, printed = trainers["fdtpu_k2"]
    assert jk._use_shardmap and type(jk.driver).__name__ == "ScanDispatchDriver"
    got = trainers["ranks"][0][f"k2_{feed}"]
    assert got["route"] == "shard_map" and not got["replays"]
    assert got["step"] == DISPATCH_IMAGES // 4
    assert_fit_matches_fdtpu(got, jk, want)
    lines, want_lines = LINE.findall(got["printed"]), LINE.findall(printed)
    assert [line[:2] for line in want_lines] == [("0", "1")]  # the group of steps 0 and 1
    if feed == "resident":
        assert lines == []
    else:
        assert [line[:2] for line in lines] == [line[:2] for line in want_lines]
        np.testing.assert_allclose([float(v) for *_, v in lines],
                                   [float(v) for *_, v in want_lines], rtol=1e-4, atol=1e-4)
    assert trainers["ranks"][1][f"k2_{feed}"]["printed"] == ""  # rank 0 alone prints


@pytest.mark.parametrize("feed", ["streamed", "resident"])
def test_dp_trainer_k2_equals_k1_bit_for_bit(trainers, feed):
    """Within the port's ranks k sets the log cadence alone: each rank's
    fits at k = 1 and k = 2 are the same bit for bit, and the ranks agree."""
    for rank in trainers["ranks"]:
        a, b = rank[f"k1_{feed}"], rank[f"k2_{feed}"]
        assert a["metrics"] == b["metrics"] and a["step"] == b["step"]
        # streamed, k = 1 takes GSPMD's route: without BatchNorm the same step
        assert (a["route"], b["route"]) == ("shard_map" if feed == "resident" else "gspmd",
                                            "shard_map")
        for k, v in a["state_dict"].items():
            assert torch.equal(v, b["state_dict"][k]), k
    r0, r1 = (r[f"k2_{feed}"] for r in trainers["ranks"])
    assert r0["metrics"] == r1["metrics"]
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k


# -- the entry points, the loader, the bootstrap -------------------------------------------


def test_outputs_keep_what_a_timed_out_process_printed():
    """A process that outruns its time is ended, and the assertion carries
    all it printed, and what the others printed."""
    code = "import sys, time; print('started', flush=True); time.sleep(60)"
    procs = [subprocess.Popen([sys.executable, "-c", "print('quick')"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    with pytest.raises(AssertionError, match="(?s)outran its 5 s.*quick.*started"):
        outputs(procs, 5)
    assert all(p.poll() is not None for p in procs)



def test_train_model_data_parallel_on_the_cpu(tmp_path):
    """``train_model --data-parallel 2 --device cpu`` starts its two gloo
    ranks: one log, one set of drawings and one checkpoint directory, all
    rank 0's; then a resume continues the step count."""
    make_synthetic_widerface(tmp_path / "data", 8, split="train", seed=0)
    make_synthetic_widerface(tmp_path / "data", 4, split="val", seed=1)
    flags = ["-m", "fdtpu_torch.train_model", "--data-dir", "data", "--input", "160",
             "--patches", "5", "--filters", "8", "--blocks", "2", "--batch-size", "4",
             "--device", "cpu", "--data-parallel", "2"]
    run = "poolresnet_8_5x5_160x160"
    for epochs, extra in ((1, []), (2, ["--resume"])):
        proc = run_entry([*flags, "--epochs", str(epochs), *extra], tmp_path)
        assert proc.returncode == 0, proc.stdout
        assert proc.stdout.count("saved:") == 1  # rank 0 alone prints
    lines = (tmp_path / "logs" / f"out_{run}.log").read_text().splitlines()
    assert [ln.split()[:2] for ln in lines] == [
        ["epoch=0", "split=training"], ["epoch=0", "split=validation"],
        ["epoch=1", "split=training"], ["epoch=1", "split=validation"]]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [run]
    assert sorted(p.name for p in (tmp_path / "checkpoints" / run).iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]  # 8 images / batch 4: 2 steps an epoch
    assert sorted(p.name for p in (tmp_path / "imgs").iterdir()) == [
        "train_epoch_0.png", "train_epoch_1.png", "validation_epoch_0.png",
        "validation_epoch_1.png"]


def test_dryrun_two_ranks_on_the_cpu():
    proc = run_entry(["-m", "fdtpu_torch.parallel.dryrun", "2", "--device", "cpu"], REPO)
    assert proc.returncode == 0, proc.stdout
    assert "dryrun OK: 2 ranks (gloo, cpu)" in proc.stdout
    assert "params identical on every rank" in proc.stdout


def test_grad_all_reduce_keeps_each_gradient_layout(tmp_path):
    """At world size 1 the reduction gives back ``g * w / w`` for every
    gradient, in a view of one buffer with the gradient's own strides
    (channels_last weights, a transposed matrix, a bias)."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(8, 3, 5, 5, generator=gen).to(memory_format=torch.channels_last),
             torch.randn(16, 16, 1, 1, generator=gen).to(memory_format=torch.channels_last),
             torch.randn(4, 6, generator=gen).t(), torch.randn(7, generator=gen)]
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                         rank=0, world_size=1)
    try:
        out = grad_all_reduce(torch.distributed.group.WORLD, torch.tensor(3))(grads)
    finally:
        torch.distributed.destroy_process_group()
    for g, o in zip(grads, out):
        assert o.shape == g.shape and o.stride() == g.stride()
        assert torch.equal(o, g * 3.0 / 3.0)
    assert len({o.untyped_storage().data_ptr() for o in out}) == 1  # one buffer


def test_initialize_multihost_is_a_no_op_alone(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()


class IndexSource:
    """A source whose every sample is its own index: image ``i`` holds
    ``i`` in its first pixel."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i):
        img = np.zeros((2, 2, 3), np.uint8)
        img[0, 0, 0] = i
        return img, np.zeros((1, 5), np.float32), np.zeros((1,), bool)


@pytest.mark.parametrize("world, shuffle, fraction", [(2, False, 1), (2, True, 1), (4, True, 2)])
def test_process_shard_indices_match_fdtpu(world, shuffle, fraction):
    """Each rank's indices, epoch by epoch, equal fdtpu's
    ``BatchLoader(process_shard=...)``, and together the ranks cover every
    global batch once."""
    src, batch = IndexSource(23), 4
    loaders = [(BatchLoader(src, batch, shuffle=shuffle, seed=3, epoch_fraction=fraction,
                            process_shard=(r, world)),
                JaxBatchLoader(src, batch, shuffle=shuffle, seed=3, epoch_fraction=fraction,
                               process_shard=(r, world))) for r in range(world)]
    for _ in range(2):  # two epochs: the shuffled order moves
        per_rank = []
        for port, ref in loaders:
            assert len(port) == len(ref) == (23 // fraction) // batch
            got = [b.images[:, 0, 0, 0].tolist() for b in port]
            assert got == [b.images[:, 0, 0, 0].tolist() for b in ref]
            assert all(len(g) == batch // world for g in got)
            per_rank.append(got)
        flat = sorted(i for got in per_rank for g in got for i in g)
        assert len(set(flat)) == len(flat) == len(port) * batch
    with pytest.raises(ValueError, match="divisible"):
        BatchLoader(src, 6, process_shard=(0, 4))
