"""The spatial axis for the rest of the zoo (Resnet, SeparableCNN,
MobileNetV3-Small, the SSD) and the GSPMD route of the data-parallel step,
on the CPU.

One launch of 4 gloo ranks, each a process that imports no JAX
(``tests/torch_parallel_ranks.py``, task ``spatial_zoo``, 2 threads
each), runs every
family on the 2x2 and the 1x4 mesh, against fdtpu's
``make_dp_train_step(spatial=True)`` on the virtual CPU mesh (conftest gives
8 devices) and against the port's one-process step on the global batch,
from the same converted params (``batch_stats`` included) on the same numpy
batch with one padded sample. Float32, augmentation and dropout off, SAM +
SGD at lr 1e-2. Sizes keep every exchange live: Resnet at 64 px and
SeparableCNN at 160 px (4 filters, 2 blocks, grids of 8 and 5 rows);
MobileNetV3 at 160 px, grid 5 (its stride-2 layers pad (0, 1) and (1, 2));
the SSD at 256 px with 4 filters (maps 32/16/8/4: one row a rank of the
last on 1x4). On ranks 0 and 1 the same launch runs MobileNetV3's
data-parallel step by the GSPMD route on the same batch, against fdtpu's
GSPMD ``make_dp_train_step`` on a 2-device mesh and the one-process step:
the fault that route fixes (fdtpu's two builders differ for BatchNorm; the
shard_map route stays held against ``make_shardmap_dp_train_step`` in
``tests/test_torch_parallel.py``). The one-process steps run at the ranks'
thread count (:func:`single_step`).

Tolerances are the existing files':

* Resnet and SeparableCNN, ``tests/test_torch_spatial.py``'s: loss rtol
  1e-5, grad norm rtol 1e-4, params atol 1e-6; the gathered grid with
  dropout against the one-process forward atol 1e-6;
* the SSD, ``tests/test_torch_ssd.py``'s: loss and grad norm rtol 1e-5,
  params rtol 1e-4 (atol 1e-7); the gathered boxes with dropout atol 1e-5;
* MobileNetV3, ``tests/test_torch_zoo.py``'s: loss and grad norm rtol 1e-5,
  params atol 1e-4, the running statistics rtol 1e-5 with atol 1e-7; its
  train-mode forward on the mesh's statistics against the one-process
  forward of the global batch atol 1e-4;
* the ranks against each other: bit-equal; at one rank, each family's
  spatial forward is the model's own, bit for bit.

The summed statistics of ``BatchNorm``'s group path against
``F.batch_norm`` on one batch: the output atol 1e-5 (float32; bfloat16:
one rounding of the same float32 value, atol 2^-7 at unit scale), the
statistics rtol 1e-5 with atol 1e-7, the input gradient atol 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch
import torch.distributed as dist

from fdtpu.models import SSD as JaxSSD
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import Resnet as JaxResnet
from fdtpu.models import SeparableCNN as JaxSeparableCNN
from fdtpu.parallel import make_dp_train_step as jax_make_dp_train_step
from fdtpu.parallel import make_mesh as jax_make_mesh
from fdtpu.parallel import shard_batch_arrays
from fdtpu_torch.compat import state_dict_from_fdtpu
from fdtpu_torch.models import (
    SSD,
    MobileNetV3Backbone,
    Resnet,
    SeparableCNN,
    ssd_patch_sizes,
)
from fdtpu_torch.models.layers import BatchNorm, DropoutMasks, same_pads
from fdtpu_torch.parallel import (
    make_dp_train_step,
    make_mesh,
    mobilenetv3_plan,
    poolresnet_plan,
    spatial_forward,
    spatial_plan,
    ssd_plan,
    trainer_route,
)
from fdtpu_torch.parallel.halo import same_exchange, window_exchange
from fdtpu_torch.parallel.mesh import data_shard, mesh_layout, row_split
from fdtpu_torch.train import Trainer, create_train_state, make_train_step
from fdtpu_torch.utils.config import TrainConfig
from test_torch_parallel import (
    STEP_CONFIG,
    grid_batch,
    jax_state,
    numpy_tree,
    outputs,
    port_single_step,
    rank_env,
)

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_parallel_ranks.py"
WORLD = 4
RANK_TIMEOUT_S = 150
LAYOUTS = {"2x2": 2, "1x4": 4}  # name: spatial size, over all 4 ranks
SSD_SIZE = (256, 256)
CTORS = {
    "resnet": (Resnet, JaxResnet, dict(filters=4, input_shape=(64, 64), num_patches=4,
                                       num_residual_blocks=2, dropout=0.0, head_dropout=0.0)),
    "separable": (SeparableCNN, JaxSeparableCNN,
                  dict(filters=4, input_shape=(160, 160), num_patches=10, num_residual_blocks=2,
                       dropout=0.0, head_dropout=0.0)),
    "mobilenetv3": (MobileNetV3Backbone, JaxMobileNetV3,
                    dict(input_shape=(160, 160), num_patches=5)),
    "ssd": (SSD, JaxSSD, dict(filters=4, input_shape=SSD_SIZE,
                              patch_sizes=ssd_patch_sizes(SSD_SIZE), dropout=0.0)),
}
DROPOUT = {"resnet": dict(dropout=0.25, head_dropout=0.5),
           "separable": dict(dropout=0.25, head_dropout=0.5), "ssd": dict(dropout=0.25)}
RANK_THREADS = 2  # tests/torch_parallel_ranks.py's
STEP_TOL = {  # loss rtol, grad norm rtol, params tolerance
    "resnet": (1e-5, 1e-4, dict(atol=1e-6, rtol=0)),
    "separable": (1e-5, 1e-4, dict(atol=1e-6, rtol=0)),
    "ssd": (1e-5, 1e-5, dict(atol=1e-7, rtol=1e-4)),
    "mobilenetv3": (1e-5, 1e-5, dict(atol=1e-4, rtol=0)),
}
FORWARD_ATOL = {"resnet": 1e-6, "separable": 1e-6, "ssd": 1e-5, "mobilenetv3": 1e-4}
STATS_TOL = dict(rtol=1e-5, atol=1e-7)


def is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# -- the plans (no processes) ----------------------------------------------------------


@pytest.mark.parametrize("n, k, s, pads", [
    (160, 3, 2, (0, 1)), (480, 3, 2, (0, 1)), (20, 5, 2, (1, 2)), (10, 5, 2, (1, 2)),
    (15, 5, 1, (2, 2)), (7, 3, 1, (1, 1)),
])
def test_same_exchange_pads_on_the_global_height(n, k, s, pads):
    """``"SAME"`` pads from the whole height (``ceil(n / s)`` rows out,
    the smaller half above): the first rank's window starts ``top`` rows
    above the image, the last one's ends ``bottom`` below, and every
    rank's window gives exactly its own output rows."""
    assert same_pads(n, k, s) == pads
    layer = torch.nn.Conv2d(1, 1, k, stride=s)
    for parts in (1, 2, 4):
        ex = same_exchange(n, layer, parts)
        assert ex.n_out == -(-n // s)
        assert ex.pads(0)[0] == pads[0] and ex.pads(parts - 1)[1] == pads[1]
        assert ex == window_exchange(n, k, s, pads, parts)
        for (lo, hi), (o0, o1) in zip(ex.need, ex.own_out):
            assert (hi - lo - k) // s + 1 == o1 - o0 > 0


def test_same_exchange_of_a_strided_layer_pads_below_only():
    """160 px, MobileNetV3's k3/s2 stem over 4 ranks: 80 rows out, 20 a
    rank; the last rank's window runs one zero row past the image, and
    each of the others reads the first row of the next rank."""
    ex = same_exchange(160, torch.nn.Conv2d(3, 16, 3, stride=2), 4)
    assert ex.own_out == ((0, 20), (20, 40), (40, 60), (60, 80))
    assert [ex.pads(i) for i in range(4)] == [(0, 0), (0, 0), (0, 0), (0, 1)]
    assert ex.slots == (40, 80, 120)


def plan_layers(family, module, plan):
    """``(exchange, k, s)`` of every exchanged layer of ``plan``, in order."""
    def k_s(layer):
        return (2, 2) if layer is None else (layer.kernel_size[0], layer.stride[0])

    if family == "mobilenetv3":
        return ([(plan.stem, *k_s(module.conv_stem))]
                + [(e, *k_s(b.conv_dw)) for e, b in zip(plan.blocks, module.blocks)]
                + [(plan.head, *k_s(module.head))])
    if family == "ssd":
        stages = plan.extractor + plan.scales
        return [(plan.stem, *k_s(module.stem))] + [
            (e, *k) for c, p in stages for e, k in ((c, (3, 1)), (p, (2, 2))) if e is not None]
    return [(plan.stem, *k_s(module.conv1))] + [
        (e, *k) for c, p in plan.blocks for e, k in ((c, (3, 1)), (p, (2, 2))) if e is not None
    ] + [(plan.head, *k_s(module.out))]


ZOO_480 = {  # chip_smoke.py phase 19's models at 4 filters (the plans need no widths)
    "resnet": lambda: Resnet(4, (480, 480), 15, 10),
    "separable": lambda: SeparableCNN(4, (480, 480), 16, 10),
    "mobilenetv3": lambda: MobileNetV3Backbone((480, 480), 15),
    "ssd": lambda: SSD(4, (480, 480), ssd_patch_sizes((480, 480))),
}
OUT_ROWS = {"resnet": 15, "separable": 10, "mobilenetv3": 15, "ssd": 7}


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("family", list(ZOO_480))
def test_plan_of_each_family_at_480(family, parts):
    """Every layer's rows split over the ranks, each window gives exactly
    the rank's rows, the image's rows are split ceil-first, and the last
    map has the model's rows: its grid (the SSD's smallest patch size, 7
    rows over up to 7 ranks)."""
    module = ZOO_480[family]()
    plan = spatial_plan(module, 480, parts)
    assert plan.image_rows == tuple(row_split(480, parts))
    layers = plan_layers(family, module, plan)
    for ex, k, s in layers:
        for i, ((lo, hi), (o0, o1)) in enumerate(zip(ex.need, ex.own_out)):
            assert o1 > o0
            assert (hi - lo - k) // s + 1 == o1 - o0
    assert layers[-1][0].n_out == OUT_ROWS[family]
    if family == "mobilenetv3":
        assert plan.stem.pads(parts - 1) == (0, 1)  # SAME: 480 -> 240 pads one row below
        assert [e.n_out for e in plan.blocks] == [120, 60, 60, 30, 30, 30, 30, 30, 15, 15, 15]
    if family == "ssd":
        assert [(p or c).n_out for c, p in plan.scales] == [60, 30, 15, 7]
    if family in ("resnet", "separable"):
        # each pool decided on the global height
        assert [p is not None for _, p in plan.blocks] == [
            n > module.residual_blocks[0].pool_until for n in (c.n_in for c, _ in plan.blocks)]


def test_ssd_plan_checks_the_global_patch_sizes():
    with pytest.raises(ValueError, match="patch size"):
        ssd_plan(SSD(4, (256, 256), (30, 15, 8, 4)), 256, 2)
    with pytest.raises(ValueError, match="do not split"):
        ssd_plan(SSD(4, (480, 480), ssd_patch_sizes((480, 480))), 480, 8)  # the 7-row map


def test_spatial_plan_dispatches_by_family():
    assert type(spatial_plan(Resnet(4, (64, 64), 4, 2), 64, 2)).__name__ == "PoolResnetPlan"
    assert mobilenetv3_plan(MobileNetV3Backbone((160, 160), 5), 160, 2).head.n_out == 5
    assert poolresnet_plan(SeparableCNN(4, (160, 160), 10, 2), 160, 4).head.n_out == 5
    with pytest.raises(ValueError, match="no spatial forward"):
        spatial_plan(torch.nn.Conv2d(3, 3, 3), 64, 2)


# -- BatchNorm over a group, and the route the Trainer takes --------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_group_path_is_flax_batch_norm(dtype):
    """With a ``sum_reduce`` that sums over one rank (the identity), the
    group path normalises as ``F.batch_norm`` does, in float32 rounded
    once, folds in the same statistics the local path folds in, and gives
    the same input gradient."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 6, 5, 7, generator=gen) * 3 + 1).to(dtype).requires_grad_()
    runs = {}
    for name, reduce in (("local", None), ("group", lambda t: t)):
        bn = BatchNorm(6)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
            bn.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(2))
        bn.sum_reduce = reduce
        y = bn(x, train=True, update_stats=True)
        (g,) = torch.autograd.grad((y.float() * torch.arange(y.numel()).reshape(y.shape)
                                    .float().sin()).sum(), x)
        runs[name] = y, g, bn.running_mean, bn.running_var
    (y0, g0, m0, v0), (y1, g1, m1, v1) = runs["local"], runs["group"]
    assert y1.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y1.float().detach().numpy(), y0.float().detach().numpy(),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(m1.numpy(), m0.numpy(), **STATS_TOL)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), **STATS_TOL)
    if dtype == torch.float32:
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rotate, resident, route", [
    (False, False, "gspmd"), (True, False, "shard_map"), (False, True, "shard_map"),
    (True, True, "shard_map"),
])
def test_trainer_takes_fdtpus_route(tmp_path, rotate, resident, route):
    """fdtpu's Trainer takes its shard_map builder with ``rotate_device``
    or ``device_data`` and its GSPMD builder otherwise; so does the
    port's."""
    config = TrainConfig(rotate_device=rotate, device_data=resident,
                         checkpoint_dir=str(tmp_path / "ckpt"),
                         log_path=str(tmp_path / "logs" / "out.log"))
    assert trainer_route(config) == route

    class Loader:
        batch_size, shuffle = 2, False

        def __len__(self):
            return 1

    module = Resnet(4, (64, 64), 4, 1)
    assert Trainer(module, config, Loader(), device="cpu").route == route


# -- one rank, in this process -------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", list(CTORS))
def test_one_rank_spatial_forward_is_the_models_forward(one_rank, family):
    """At one rank every exchange is the identity and every layer the
    model's own call: bit-equal, dropout on (MobileNetV3: train mode with a
    statistics update, and eval mode)."""
    cls, _, ctor = CTORS[family]
    ctor = dict(ctor, **DROPOUT.get(family, {}))
    module = cls(**ctor, generator=torch.Generator().manual_seed(0))
    twin = cls(**ctor)
    twin.load_state_dict(module.state_dict())
    size = ctor["input_shape"][0]
    images = torch.rand(2, size, size, 3, generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(1, 1)
    plan = spatial_plan(module, size, 1)
    if family == "mobilenetv3":
        for train in (True, False):
            got = spatial_forward(module, images, plan, mesh, train=train, update_stats=True)
            assert torch.equal(got, twin(images, train=train, update_stats=True))
        for a, b in zip(module.buffers(), twin.buffers()):
            assert torch.equal(a, b)
        return
    masks = [DropoutMasks(torch.Generator().manual_seed(2)) for _ in range(2)]
    assert torch.equal(spatial_forward(module, images, plan, mesh, masks[0]),
                       twin(images, masks[1]))


def test_one_rank_gspmd_route_is_the_plain_step(one_rank):
    """MobileNetV3's GSPMD-route step at world 1: its BatchNorms are the
    model's own and its loss weight is 1, so it is the plain step bit for
    bit, running statistics included."""
    batch = [torch.from_numpy(a) for a in grid_batch((96, 96), seed=1)]
    ctor = dict(input_shape=(96, 96), num_patches=3)
    runs = {}
    for name in ("plain", "gspmd"):
        module = MobileNetV3Backbone(**ctor, generator=torch.Generator().manual_seed(0))
        cfg = TrainConfig(**STEP_CONFIG)
        state = create_train_state(module, cfg, 10)
        step = (make_train_step(module, cfg, augment=False) if name == "plain" else
                make_dp_train_step(module, cfg, route="gspmd", augment=False))
        _, scalars = step(state, *batch)
        runs[name] = scalars, module.state_dict()
    (sp, dp), (sg, dg) = runs["plain"], runs["gspmd"]
    assert sg["loss"].item() == sp["loss"].item()
    assert sg["grad_norm"].item() == sp["grad_norm"].item()
    for k, v in dp.items():
        assert torch.equal(dg[k], v), k


def test_make_dp_train_step_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="route"):
        make_dp_train_step(Resnet(4, (64, 64), 4, 1), TrainConfig(), group=object(),
                           route="pmap")


# -- four ranks, against fdtpu -------------------------------------------------------------


def start_ranks(work: Path) -> list[subprocess.Popen]:
    init = f"file://{work / 'rendezvous_spatial_zoo'}"
    return [subprocess.Popen([sys.executable, str(RANKS), "spatial_zoo", str(r), str(WORLD), init,
                              str(work)], cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def finish_ranks(procs, work: Path) -> list[dict]:
    """Each rank must exit 0 within the timeout."""
    logs = outputs(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(work / f"spatial_zoo_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def family_batch(family):
    size = CTORS[family][2]["input_shape"]
    batch = grid_batch(size, seed=3 if family == "ssd" else 1)
    batch[3][-1] = False  # one padded sample: the 2x2 data rows weigh 2 and 1
    return batch


def single_step(module, batch):
    """The port's one-process step at the ranks' thread count: oneDNN picks
    its kernels by it, and MobileNetV3's grad norm moves by up to 2e-5
    between them (its ``bn3`` biases' gradients are rounding noise,
    ``tests/test_torch_zoo.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        return port_single_step(module, batch)
    finally:
        torch.set_num_threads(threads)


def converted(cls, ctor, state):
    """fdtpu's params (and statistics) as ``cls(**ctor)``'s state_dict."""
    return state_dict_from_fdtpu(numpy_tree(state.params), cls(**ctor),
                                 numpy_tree(state.batch_stats) if state.batch_stats else None)


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    """The port's four ranks (started first, so that they run while fdtpu
    compiles), fdtpu's spatial GSPMD steps on a (2, 2) and a (1, 4) mesh
    and its GSPMD DP step on 2 devices, and the port's one-process steps."""
    work = tmp_path_factory.mktemp("spatial_zoo")
    families, jax_models = {}, {}
    for family, (cls, jcls, ctor) in CTORS.items():
        jm = jcls(**ctor, dtype=jnp.float32)
        state, _, _ = jax_state(jm, ctor["input_shape"])
        jax_models[family] = jm
        families[family] = dict(family=family, ctor=ctor, state_dict=converted(cls, ctor, state),
                                dropout_ctor=dict(ctor, **DROPOUT.get(family, {})),
                                batch=family_batch(family))
    torch.save({"spatial_zoo": {"families": families, "gspmd": families["mobilenetv3"],
                                "config": STEP_CONFIG, "layouts": LAYOUTS}}, work / "inputs.pt")
    procs = start_ranks(work)
    try:
        fdtpu, single = {}, {}
        for family, jm in jax_models.items():
            case = families[family]
            for name, spatial in LAYOUTS.items():
                state, tx, jcfg = jax_state(jm, case["ctor"]["input_shape"])  # the step donates
                mesh = jax_make_mesh(WORLD, spatial=spatial)
                step = jax_make_dp_train_step(jm, tx, jcfg, mesh, augment=False, spatial=True)
                new, sc = step(state, *shard_batch_arrays(mesh, *case["batch"],
                                                          spatial_image_dim=1),
                               jax.random.PRNGKey(5))
                fdtpu[family, name] = (converted(CTORS[family][0], case["ctor"], new),
                                       {k: float(v) for k, v in sc.items()})
            module = CTORS[family][0](**case["ctor"])
            module.load_state_dict(case["state_dict"])
            single[family] = single_step(module, case["batch"])
        jm, case = jax_models["mobilenetv3"], families["mobilenetv3"]
        state, tx, jcfg = jax_state(jm, case["ctor"]["input_shape"])
        mesh = jax_make_mesh(2)
        step = jax_make_dp_train_step(jm, tx, jcfg, mesh, augment=False)
        new, sc = step(state, *shard_batch_arrays(mesh, *case["batch"]), jax.random.PRNGKey(5))
        fdtpu["gspmd"] = (converted(MobileNetV3Backbone, case["ctor"], new),
                          {k: float(v) for k, v in sc.items()})
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    ranks = finish_ranks(procs, work)
    return {"families": families, "fdtpu": fdtpu, "single": single, "ranks": ranks}


def assert_step(got, start, refs, family):
    """``got`` (scalars, state_dict) against each reference ``(state_dict,
    scalars)`` at ``family``'s tolerances; every param moved."""
    loss_rtol, gn_rtol, params_tol = STEP_TOL[family]
    for ref_sd, ref_sc in refs:
        np.testing.assert_allclose(got["scalars"]["loss"], ref_sc["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(got["scalars"]["grad_norm"], ref_sc["grad_norm"], rtol=gn_rtol)
        for k, v in ref_sd.items():
            tol = STATS_TOL if is_stat(k) else params_tol
            assert not torch.equal(got["state_dict"][k], start[k]), k  # the step moved it
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), **tol,
                                       err_msg=k)


def assert_ranks_equal(outs):
    for r in outs[1:]:
        assert r["scalars"] == outs[0]["scalars"]
        for k, v in r["state_dict"].items():
            assert torch.equal(v, outs[0]["state_dict"][k]), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", list(CTORS))
def test_spatial_step_matches_fdtpu_and_the_global_batch(zoo_runs, family, layout):
    outs = [r[family, layout] for r in zoo_runs["ranks"]]
    assert_ranks_equal(outs)
    assert outs[0]["step"] == 1
    single_sc, single_sd = zoo_runs["single"][family]
    jsd, jsc = zoo_runs["fdtpu"][family, layout]
    start = zoo_runs["families"][family]["state_dict"]
    if family == "mobilenetv3":
        assert sum(map(is_stat, jsd)) == 2 * 34  # every BatchNorm's statistics held
    assert_step(outs[0], start, [(jsd, jsc), (single_sd, single_sc)], family)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", list(CTORS))
def test_spatial_forward_matches_one_process(zoo_runs, family, layout):
    """Every rank's gathered output against the one-process forward: of its
    data row with the same dropout masks (a generator seeded with the data
    index), or for MobileNetV3 in train mode, of the global batch (the
    statistics span the whole mesh); the ranks of a row hold the same
    output, bit for bit."""
    case = zoo_runs["families"][family]
    cls = CTORS[family][0]
    module = cls(**case["dropout_ctor"])
    module.load_state_dict(case["state_dict"])
    images = torch.from_numpy(case["batch"][0]).float() / 255
    spatial = LAYOUTS[layout]
    with torch.no_grad():
        whole = module(images, train=True, update_stats=False) if family == "mobilenetv3" \
            else None
    for rank, out in enumerate(r[family, layout] for r in zoo_runs["ranks"]):
        mesh = mesh_layout(WORLD, spatial, rank)
        (rows,) = data_shard(mesh, images)
        with torch.no_grad():
            if whole is not None:
                (want,) = data_shard(mesh, whole)
            else:
                want = module(rows, DropoutMasks(torch.Generator().manual_seed(out["data_index"])))
                assert (out["output"] - module(rows)).abs().max() > 1e-3  # the masks dropped
        np.testing.assert_allclose(out["output"].numpy(), want.numpy(),
                                   atol=FORWARD_ATOL[family], rtol=0)
        first = zoo_runs["ranks"][rank - rank % spatial][family, layout]["output"]
        assert torch.equal(out["output"], first)


def test_gspmd_route_batch_norm_matches_fdtpus_gspmd_step(zoo_runs):
    """F8: MobileNetV3's data-parallel step on 2 ranks (b2 + b2, one padded
    sample) by the GSPMD route, statistics over the global batch, equals
    fdtpu's GSPMD ``make_dp_train_step`` and the one-process step on the
    global batch, params and running statistics."""
    outs = [r["gspmd"] for r in zoo_runs["ranks"][:2]]
    assert all("gspmd" not in r for r in zoo_runs["ranks"][2:])
    assert_ranks_equal(outs)
    assert outs[0]["step"] == 1
    single_sc, single_sd = zoo_runs["single"]["mobilenetv3"]
    jsd, jsc = zoo_runs["fdtpu"]["gspmd"]
    assert sum(map(is_stat, jsd)) == 2 * 34
    assert_step(outs[0], zoo_runs["families"]["mobilenetv3"]["state_dict"],
                [(jsd, jsc), (single_sd, single_sc)], "mobilenetv3")


def test_gspmd_route_differs_from_the_shard_map_route(zoo_runs):
    """What F8 was: each rank's own statistics, averaged (the shard_map
    route's), are not the global batch's. Against the GSPMD route's after
    one step they are apart by far more than the tolerance."""
    case = zoo_runs["families"]["mobilenetv3"]
    got = zoo_runs["ranks"][0]["gspmd"]["state_dict"]
    images = torch.from_numpy(case["batch"][0]).float() / 255
    per_rank = []
    for rank in range(2):
        module = MobileNetV3Backbone(**case["ctor"])
        module.load_state_dict(case["state_dict"])
        with torch.no_grad():
            module(images[2 * rank:2 * rank + 2], train=True, update_stats=True)
        per_rank.append(module.state_dict())
    worst = max((got[k] - (per_rank[0][k] + per_rank[1][k]) / 2).abs().max().item()
                for k in got if is_stat(k))
    assert worst > 1e-3
