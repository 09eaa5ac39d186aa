"""The port's spatial axis on the CPU: a data x spatial grid of gloo ranks,
each a process that imports no JAX (``tests/torch_parallel_ranks.py``, task
``spatial``, with a ``file://`` rendezvous under the test's temporary
directory), against fdtpu's ``make_dp_train_step(spatial=True)`` on the
virtual CPU mesh (conftest gives 8 devices) and against the port's
one-process step on the global batch, from the same converted params on the
same numpy batch.

One launch of 4 ranks runs both layouts, 2x2 and 1x4, each a mesh over all
four. Float32, augmentation and dropout off, SAM + SGD at lr 1e-2;
PoolResnet at 160 px, 8 filters, 2 blocks, num_patches 5 (the stem's 20
rows pool to 10, the head gives 5), one padded sample. Tolerances are
``tests/test_torch_parallel.py``'s: loss rtol 1e-5, grad norm rtol 1e-4,
params atol 1e-6; the ranks against each other bit-equal. The spatial
forward with dropout on against the one-process forward with the same
masks: atol 1e-6 (float32; the windows' convolutions sum in the model's
order, only the shapes oneDNN sees differ). At one rank the spatial forward
is the model's own, bit for bit.
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

from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.parallel import make_dp_train_step as jax_make_dp_train_step
from fdtpu.parallel import make_mesh as jax_make_mesh
from fdtpu.parallel import shard_batch_arrays
from fdtpu_torch.compat import state_dict_from_fdtpu
from fdtpu_torch.models import PoolResnet
from fdtpu_torch.models.layers import DropoutMasks
from fdtpu_torch.parallel import make_dp_train_step, make_mesh, poolresnet_plan, spatial_forward
from fdtpu_torch.parallel.halo import pool_exchange, window_exchange
from fdtpu_torch.parallel.mesh import data_shard, mesh_layout, row_split, shard_rows
from fdtpu_torch.train import create_train_state, make_train_step
from fdtpu_torch.utils.config import TrainConfig
from test_torch_parallel import (
    STEP_CONFIG,
    grid_batch,
    jax_state,
    numpy_tree,
    port_single_step,
    outputs,
    rank_env,
    run_entry,
)

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_parallel_ranks.py"
WORLD = 4
RANK_TIMEOUT_S = 60
POOL = dict(filters=8, input_shape=(160, 160), num_patches=5, num_residual_blocks=2,
            dropout=0.0, head_dropout=0.0)
DROPOUT = dict(POOL, dropout=0.25, head_dropout=0.5)
LAYOUTS = {"2x2": 2, "1x4": 4}  # name: spatial size, over all 4 ranks
FORWARD_ATOL = 1e-6


# -- the row tables (no processes) -------------------------------------------------------


def owner(ex, row):
    return next(i for i, (a, b) in enumerate(ex.own_in) if a <= row < b)


def fetched(ex, i):
    """The rows rank ``i``'s window reads from other ranks."""
    (c0, c1), (a, b) = ex.clipped(i), ex.own_in[i]
    return [r for r in range(c0, c1) if not a <= r < b]


def test_row_split_is_ceil_first():
    assert row_split(15, 2) == [(0, 8), (8, 15)]
    assert row_split(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert row_split(5, 4) == [(0, 2), (2, 3), (3, 4), (4, 5)]
    assert [b - a for a, b in row_split(480, 2)] == [240, 240]


@pytest.mark.parametrize("size, patches, blocks, parts, heights, pools", [
    (160, 5, 2, 2, [20, 10], [True, False]),
    (160, 5, 2, 4, [20, 10], [True, False]),
    (320, 15, 10, 2, [40] + [20] * 9, [True] + [False] * 9),
    (480, 10, 10, 2, [60, 30] + [15] * 8, [True, True] + [False] * 8),
])
def test_plan_pools_on_the_global_height(size, patches, blocks, parts, heights, pools):
    """Each block's rows and pool follow the whole image, as
    ``PoolResnet.forward`` pools, whatever a shard's height; every rank
    owns rows of every layer, and a window's rows, padding included, give
    exactly the rank's output rows."""
    module = PoolResnet(4, (size, size), patches, blocks)
    plan = poolresnet_plan(module, size, parts)
    assert [c.n_in for c, _ in plan.blocks] == heights
    assert [p is not None for _, p in plan.blocks] == pools
    assert plan.head.n_out == module.grid_size() == patches
    assert plan.image_rows == tuple(row_split(size, parts))
    layers = [(plan.stem, module.conv1)] + [
        (e, layer) for (c, p), b in zip(plan.blocks, module.residual_blocks)
        for e, layer in ((c, b.conv1), (p, None)) if e is not None] + [(plan.head, module.out)]
    for ex, layer in layers:
        k, s = (2, 2) if layer is None else (layer.kernel_size[0], layer.stride[0])
        for i, ((lo, hi), (o0, o1)) in enumerate(zip(ex.need, ex.own_out)):
            assert o1 > o0
            assert (hi - lo - k) // s + 1 == o1 - o0
            assert all(owner(ex, r) != i for r in fetched(ex, i))


def test_480_straddles_the_pool_and_moves_head_rows_both_ways():
    """480 px, grid 10, 2 ranks: the stem's rank 1 reads image rows 238 and
    239; block 2 pools 30 rows to 15 (8 + 7), and rank 0 reads the pair
    (14, 15) across the edge; the k=6 head turns 15 rows into 10 (5 + 5),
    rank 0 reading rows 8-9 of rank 1 and rank 1 rows 5-7 of rank 0."""
    plan = poolresnet_plan(PoolResnet(4, (480, 480), 10, 10), 480, 2)
    assert plan.stem.own_out == ((0, 30), (30, 60))
    assert (fetched(plan.stem, 0), fetched(plan.stem, 1)) == ([], [238, 239])
    assert plan.stem.pads(0) == (2, 0) and plan.stem.pads(1) == (0, 0)
    pool2 = plan.blocks[1][1]
    assert pool2.own_in == ((0, 15), (15, 30)) and pool2.own_out == ((0, 8), (8, 15))
    assert (fetched(pool2, 0), fetched(pool2, 1)) == ([15], [])
    assert plan.blocks[0][1].slots == ()  # 60 -> 30 pools aligned
    assert plan.head.own_in == ((0, 8), (8, 15)) and plan.head.own_out == ((0, 5), (5, 10))
    assert (fetched(plan.head, 0), fetched(plan.head, 1)) == ([8, 9], [5, 6, 7])


def test_160_over_4_head_window_reaches_across_two_ranks():
    """160 px, num_patches 5, 4 ranks: the stem's 20 rows (5 a rank) pool to
    10 (3 + 3 + 2 + 2) with pairs across edges; the head's 5 rows are
    2 + 1 + 1 + 1, and rank 0's window of 7 rows reads ranks 1 and 2."""
    plan = poolresnet_plan(PoolResnet(4, (160, 160), 5, 2), 160, 4)
    assert plan.stem.own_out == ((0, 5), (5, 10), (10, 15), (15, 20))
    pool = plan.blocks[0][1]
    assert pool.own_out == ((0, 3), (3, 6), (6, 8), (8, 10))
    assert [fetched(pool, i) for i in range(4)] == [[5], [10, 11], [15], []]
    head = plan.head
    assert head.own_out == ((0, 2), (2, 3), (3, 4), (4, 5))
    assert head.need[0] == (0, 7)
    assert fetched(head, 0) == [3, 4, 5, 6]
    assert sorted({owner(head, r) for r in fetched(head, 0)}) == [1, 2]
    assert fetched(head, 3) == [4, 5, 6, 7]  # a window can also reach back past a rank


def test_exchange_slots_and_runs():
    """The slots are the rows read by a rank that does not own them; an
    owner's slots are written in runs of consecutive rows, and a window
    reads its slots above and below its own rows in two ranges."""
    ex = window_exchange(10, 6, 1, 0, 4)  # the 160/5 head over 4 ranks
    assert ex.slots == tuple(range(2, 9))  # row 9: read by its owner alone
    assert ex.writes(1) == [(1, 0, 3)]  # rows 3-5, slots 1-3
    before, mine, after = ex.runs(2)  # window rows 3-8, own 6-7
    assert (before, mine, after) == ((1, 3), (0, 2), (6, 1))
    assert pool_exchange(20, 2).slots == ()


def test_mesh_layout_and_shards():
    """fdtpu's ``devices.reshape(n // spatial, spatial)``: rank r at data
    index r // spatial and spatial index r % spatial; a world that does not
    divide raises ``ValueError``."""
    mesh = mesh_layout(8, 4, 6)
    assert (mesh.shape, mesh.data_index, mesh.spatial_index) == ((2, 4), 1, 2)
    images = torch.arange(4 * 10 * 3 * 1).reshape(4, 10, 3, 1)
    rows = shard_rows(images, mesh)
    assert torch.equal(rows, images[2:, 6:8])  # data row 1; rows 6-7 of 3 + 3 + 2 + 2
    assert torch.equal(data_shard(mesh, images)[0], images[2:])
    for world, spatial in ((4, 3), (6, 4), (2, 0)):
        with pytest.raises(ValueError, match="does not divide"):
            mesh_layout(world, spatial, 0)


# -- one rank, in this process -------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_checks_the_group(one_rank):
    mesh = make_mesh(1, 1)
    assert mesh.shape == (1, 1) and (mesh.data_index, mesh.spatial_index) == (0, 0)
    with pytest.raises(ValueError, match="2 ranks but the process group has 1"):
        make_mesh(2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(1, 2)


def test_one_rank_spatial_forward_is_the_models_forward(one_rank):
    """At spatial 1 every exchange is the identity and every layer the
    model's own call: bit-equal, dropout on."""
    module = PoolResnet(**DROPOUT, generator=torch.Generator().manual_seed(0))
    images = torch.rand(2, 160, 160, 3, generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(1, 1)
    plan = poolresnet_plan(module, 160, 1)
    masks = [DropoutMasks(torch.Generator().manual_seed(2)) for _ in range(2)]
    got = spatial_forward(module, images, plan, mesh, masks[0])
    want = module(images, masks[1])
    assert torch.equal(got, want)


def test_one_rank_spatial_step_is_the_plain_step(one_rank):
    """The data x spatial step at world 1 against the plain step, from the
    same params, augmentation and dropout off: the same loss; the update
    within the weighted reduction's ``g * w / w`` rounding."""
    batch = [torch.from_numpy(a) for a in grid_batch((160, 160))]
    runs = {}
    for name in ("plain", "spatial"):
        module = PoolResnet(**POOL, generator=torch.Generator().manual_seed(0))
        cfg = TrainConfig(**STEP_CONFIG)
        state = create_train_state(module, cfg, 10)
        step = (make_train_step(module, cfg, augment=False) if name == "plain" else
                make_dp_train_step(module, cfg, mesh=make_mesh(1, 1), augment=False))
        _, scalars = step(state, *batch)
        runs[name] = scalars, [p.detach().clone() for p in module.parameters()]
    (sp, pp), (ss, ps) = runs["plain"], runs["spatial"]
    assert ss["loss"].item() == sp["loss"].item()
    np.testing.assert_allclose(ss["grad_norm"].item(), sp["grad_norm"].item(), rtol=1e-6)
    for a, b in zip(ps, pp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


# -- four ranks, against fdtpu -------------------------------------------------------------


def run_ranks(task: str, work: Path) -> list[dict]:
    """The 4 ranks of ``task``; each must exit 0 within the timeout."""
    init = f"file://{work / ('rendezvous_' + task)}"
    procs = [subprocess.Popen([sys.executable, str(RANKS), task, str(r), str(WORLD), init,
                               str(work)], cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = outputs(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(work / f"{task}_rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """fdtpu's spatial GSPMD step on a (2, 2) and a (1, 4) mesh, the port's
    one-process step, and the port's four ranks under both layouts."""
    work = tmp_path_factory.mktemp("spatial")
    jm = JaxPoolResnet(**POOL, dtype=jnp.float32)
    batch = grid_batch((160, 160))
    batch[3][-1] = False  # one padded sample: the 2x2 data rows weigh 2 and 1
    state, _, _ = jax_state(jm, POOL["input_shape"])
    sd = state_dict_from_fdtpu(numpy_tree(state.params), PoolResnet(**POOL))
    fdtpu = {}
    for name, spatial in LAYOUTS.items():
        state, tx, jcfg = jax_state(jm, POOL["input_shape"])  # the step donates its state
        mesh = jax_make_mesh(WORLD, spatial=spatial)
        step = jax_make_dp_train_step(jm, tx, jcfg, mesh, augment=False, spatial=True)
        fdtpu[name] = step(state, *shard_batch_arrays(mesh, *batch, spatial_image_dim=1),
                           jax.random.PRNGKey(5))
    module = PoolResnet(**POOL)
    module.load_state_dict(sd)
    single = port_single_step(module, batch)
    spec = dict(family="poolresnet", ctor=POOL, dropout_ctor=DROPOUT, state_dict=sd,
                config=STEP_CONFIG, batch=batch, layouts=LAYOUTS)
    torch.save({"spatial": spec}, work / "inputs.pt")
    return {"spec": spec, "fdtpu": fdtpu, "single": single, "ranks": run_ranks("spatial", work)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_step_matches_fdtpu_and_the_global_batch(spatial_runs, layout):
    ranks = [r[layout] for r in spatial_runs["ranks"]]
    for r in ranks[1:]:  # every rank bit-equal to rank 0
        assert r["scalars"] == ranks[0]["scalars"]
        for k, v in r["state_dict"].items():
            assert torch.equal(v, ranks[0]["state_dict"][k]), k
    got = ranks[0]
    assert got["step"] == 1
    jnew, jsc = spatial_runs["fdtpu"][layout]
    want = state_dict_from_fdtpu(numpy_tree(jnew.params), PoolResnet(**POOL))
    single_sc, single_sd = spatial_runs["single"]
    start = spatial_runs["spec"]["state_dict"]
    for ref_loss, ref_gn, ref_sd in ((float(jsc["loss"]), float(jsc["grad_norm"]), want),
                                    (single_sc["loss"], single_sc["grad_norm"], single_sd)):
        np.testing.assert_allclose(got["scalars"]["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(got["scalars"]["grad_norm"], ref_gn, rtol=1e-4)
        for k, v in ref_sd.items():
            assert not torch.equal(got["state_dict"][k], start[k]), k  # the step moved it
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_forward_with_dropout_matches_one_process(spatial_runs, layout):
    """Every rank's gathered grid equals the one-process forward of its data
    row with the same masks (a generator seeded with the data index); the
    ranks of a row hold the same grid, bit for bit."""
    spec = spatial_runs["spec"]
    module = PoolResnet(**DROPOUT)
    module.load_state_dict(spec["state_dict"])
    spatial = LAYOUTS[layout]
    images = torch.from_numpy(spec["batch"][0]).float() / 255
    for rank, out in enumerate(r[layout] for r in spatial_runs["ranks"]):
        (rows,) = data_shard(mesh_layout(WORLD, spatial, rank), images)
        with torch.no_grad():
            want = module(rows, DropoutMasks(torch.Generator().manual_seed(out["data_index"])))
            plain = module(rows)
        assert (out["grid"] - plain).abs().max() > 1e-3  # the masks dropped channels
        np.testing.assert_allclose(out["grid"].numpy(), want.numpy(), atol=FORWARD_ATOL, rtol=0)
        first = spatial_runs["ranks"][rank - rank % spatial][layout]["grid"]
        assert torch.equal(out["grid"], first)


def test_dryrun_four_ranks_is_data_by_spatial():
    proc = run_entry(["-m", "fdtpu_torch.parallel.dryrun", "4", "--device", "cpu"], REPO)
    assert proc.returncode == 0, proc.stdout
    assert "dryrun OK: 4 ranks (gloo, cpu), mesh {'data': 2, 'spatial': 2}, batch 4" in proc.stdout
    assert "params identical on every rank" in proc.stdout
