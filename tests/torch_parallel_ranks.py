"""The ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_spatial.py``: one process a rank, gloo on the CPU, torch
and fdtpu_torch only (no JAX).

    python tests/torch_parallel_ranks.py TASK RANK WORLD INIT_METHOD WORK

``WORK/inputs.pt`` holds what the test prepared (converted params, numpy
batches, the synthetic dataset's path); the rank writes
``WORK/<TASK>_rank<RANK>.pt``. Tasks:

* ``steps``: each case of ``inputs["steps"]``, one data-parallel train step
  (or eval step) on the rank's slice of the case's global batch, from the
  case's params;
* ``trainer``: ``Trainer(data_parallel=WORLD)`` for one epoch and an eval,
  streamed and then resident, from the same params; then on the larger
  dataset ``inputs["trainer"]["root_k"]`` at ``steps_per_dispatch`` 1 and
  2, streamed and resident, each fit's printed step lines kept;
* ``spatial``: for each layout of ``inputs["spatial"]["layouts"]`` (a
  spatial size; every mesh spans all ranks), one data x spatial train step
  on the rank's data row of the global batch, and the spatial forward with
  dropout masks drawn from a generator seeded with the data index;
* ``spatial_zoo``: the same for each family of ``inputs["spatial_zoo"]
  ["families"]`` (MobileNetV3's forward in train mode, on the statistics of
  the whole mesh's batch, instead of dropout), and on ranks 0 and 1 one
  GSPMD-route data-parallel step of ``inputs["spatial_zoo"]["gspmd"]``
  (each rank its half of the batch).
"""

from __future__ import annotations

import contextlib
import datetime
import io
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets  # noqa: E402
from fdtpu_torch.models import (  # noqa: E402
    SSD,
    MobileNetV3Backbone,
    PoolResnet,
    Resnet,
    SeparableCNN,
)
from fdtpu_torch.models.layers import DropoutMasks  # noqa: E402
from fdtpu_torch.parallel import (  # noqa: E402
    data_shard,
    initialize_multihost,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    poolresnet_plan,
    shutdown,
    spatial_forward,
    spatial_plan,
)
from fdtpu_torch.train import Trainer, create_train_state  # noqa: E402
from fdtpu_torch.utils.config import TrainConfig  # noqa: E402

FAMILIES = {"poolresnet": PoolResnet, "ssd": SSD, "mobilenetv3": MobileNetV3Backbone,
            "resnet": Resnet, "separable": SeparableCNN}


def build(case: dict) -> torch.nn.Module:
    module = FAMILIES[case["family"]](**case["ctor"])
    module.load_state_dict(case["state_dict"])
    return module


def rank_slice(batch, rank: int, world: int):
    lb = batch[0].shape[0] // world
    return [torch.from_numpy(a[rank * lb:(rank + 1) * lb].copy()) for a in batch]


def steps(rank: int, world: int, inputs: dict) -> dict:
    out = {}
    for name, case in inputs["steps"].items():
        module = build(case)
        state = create_train_state(module, TrainConfig(**case["config"]), 10)
        batch = rank_slice(case["batch"], rank, world)
        if case["kind"] == "eval":
            step = make_dp_eval_step(module, nms_params=case["nms"])
            scalars = step(state, *batch)
        else:
            step = make_dp_train_step(module, TrainConfig(**case["config"]), augment=False)
            state, scalars = step(state, *batch)
        out[name] = {"scalars": {k: v.item() for k, v in scalars.items()},
                     "state_dict": {k: v.clone() for k, v in module.state_dict().items()},
                     "step": state.step}
    return out


def dp_trainer(spec: dict, root: str, rank: int, world: int, name: str, **config):
    """A ``Trainer(data_parallel=world)`` of the spec's model on ``root``'s
    splits, this rank's shard of each batch; rank 1 starts from other
    params (the Trainer broadcasts rank 0's)."""
    shard = (rank, world)
    srcs = [WIDERFaceDataSource(load_targets(root, split, 3), spec["size"], box_capacity=4,
                                error_log=None, use_native=False) for split in ("train", "val")]
    train = BatchLoader(srcs[0], spec["batch"], process_shard=shard)
    val = BatchLoader(srcs[1], spec["batch"], process_shard=shard)
    work = Path(spec["work"]) / name
    config = TrainConfig(**{**spec["config"], **config}, data_parallel=world,
                         checkpoint_dir=str(work / "ckpt"), log_path=str(work / "out.log"))
    module = build(spec)
    if rank:
        with torch.no_grad():
            for p in module.parameters():
                p.add_(1.0)
    return Trainer(module, config, train, val, augment=False, nms_params=spec["nms"],
                   run_name="dp", device="cpu")


def fitted(t: Trainer, metrics: dict, **extra) -> dict:
    return {"metrics": metrics, "step": t.state.step, "driver": type(t.driver).__name__,
            "route": t.route, "replays": t.replaying,
            "state_dict": {k: v.clone() for k, v in t.state.module.state_dict().items()}, **extra}


def trainer(rank: int, world: int, inputs: dict) -> dict:
    spec = inputs["trainer"]
    out = {}
    for resident in (False, True):
        name = "resident" if resident else "streamed"
        t = dp_trainer(spec, spec["root"], rank, world, name, device_data=resident)
        out[name] = fitted(t, t.fit(), ckpt=str(t.save()))
        # every rank reads rank 0's checkpoint
        resumed = Trainer(build(spec), t.config, t.train_loader, t.val_loader, augment=False,
                          nms_params=spec["nms"], run_name="dp", device="cpu")
        assert resumed.maybe_resume() and resumed.state.step == t.state.step
        for k, v in resumed.state.module.state_dict().items():
            assert torch.equal(v, out[name]["state_dict"][k]), k
    for resident in (False, True):
        for k in (1, 2):
            name = f"k{k}_{'resident' if resident else 'streamed'}"
            t = dp_trainer(spec, spec["root_k"], rank, world, name, device_data=resident,
                           steps_per_dispatch=k, log_every_steps=spec["log_every_steps"])
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                metrics = t.fit()
            out[name] = fitted(t, metrics, printed=printed.getvalue())
    return out


def spatial(rank: int, world: int, inputs: dict) -> dict:
    spec = inputs["spatial"]
    meshes = {name: make_mesh(world, s) for name, s in spec["layouts"].items()}
    out = {}
    for name, mesh in meshes.items():
        module = build(spec)
        config = TrainConfig(**spec["config"])
        state = create_train_state(module, config, 10)
        step = make_dp_train_step(module, config, mesh=mesh, augment=False)
        batch = [torch.from_numpy(a.copy()) for a in data_shard(mesh, *spec["batch"])]
        state, scalars = step(state, *batch)
        dropout = FAMILIES[spec["family"]](**spec["dropout_ctor"])
        dropout.load_state_dict(spec["state_dict"])
        plan = poolresnet_plan(dropout, batch[0].shape[1], mesh.spatial)
        a, b = plan.image_rows[mesh.spatial_index]
        masks = DropoutMasks(torch.Generator().manual_seed(mesh.data_index))
        with torch.no_grad():
            grid = spatial_forward(dropout, batch[0][:, a:b].float() / 255, plan, mesh, masks)
        out[name] = {"scalars": {k: v.item() for k, v in scalars.items()},
                     "state_dict": {k: v.clone() for k, v in module.state_dict().items()},
                     "step": state.step, "data_index": mesh.data_index, "grid": grid}
    return out


def stepped(module, state, scalars) -> dict:
    return {"scalars": {k: v.item() for k, v in scalars.items()},
            "state_dict": {k: v.clone() for k, v in module.state_dict().items()},
            "step": state.step}


def zoo_forward(case: dict, mesh, images: torch.Tensor) -> torch.Tensor:
    """The spatial forward of the case's family from this rank's rows of
    its data row: dropout on (masks seeded with the data index), or
    MobileNetV3 in train mode without a statistics update."""
    module = FAMILIES[case["family"]](**case.get("dropout_ctor", case["ctor"]))
    module.load_state_dict(case["state_dict"])
    plan = spatial_plan(module, images.shape[1], mesh.spatial)
    a, b = plan.image_rows[mesh.spatial_index]
    rows = images[:, a:b].float() / 255
    with torch.no_grad():
        if case["family"] == "mobilenetv3":
            return spatial_forward(module, rows, plan, mesh, train=True, update_stats=False)
        masks = DropoutMasks(torch.Generator().manual_seed(mesh.data_index))
        return spatial_forward(module, rows, plan, mesh, masks)


def spatial_zoo(rank: int, world: int, inputs: dict) -> dict:
    spec = inputs["spatial_zoo"]
    meshes = {name: make_mesh(world, s) for name, s in spec["layouts"].items()}
    pair = make_mesh(2, 1)  # the GSPMD-route step's two ranks (None on the others)
    config = TrainConfig(**spec["config"])
    out = {}
    for family, case in spec["families"].items():
        for name, mesh in meshes.items():
            module = build(case)
            state = create_train_state(module, config, 10)
            step = make_dp_train_step(module, config, mesh=mesh, augment=False)
            batch = [torch.from_numpy(a.copy()) for a in data_shard(mesh, *case["batch"])]
            state, scalars = step(state, *batch)
            out[family, name] = dict(stepped(module, state, scalars), data_index=mesh.data_index,
                                     output=zoo_forward(case, mesh, batch[0]))
    if pair is not None:
        case = spec["gspmd"]
        module = build(case)
        state = create_train_state(module, config, 10)
        step = make_dp_train_step(module, config, group=pair.group, route="gspmd",
                                  augment=False)
        state, scalars = step(state, *rank_slice(case["batch"], rank, 2))
        out["gspmd"] = stepped(module, state, scalars)
    return out


def main() -> None:
    task, rank, world, init_method, work = sys.argv[1:]
    rank, world, work = int(rank), int(world), Path(work)
    torch.set_num_threads(2)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device="cpu",
                         timeout=datetime.timedelta(seconds=60))
    try:
        assert dist.get_backend() == "gloo"
        inputs = torch.load(work / "inputs.pt", weights_only=False)
        tasks = {"steps": steps, "trainer": trainer, "spatial": spatial,
                 "spatial_zoo": spatial_zoo}
        result = tasks[task](rank, world, inputs)
        torch.save(result, work / f"{task}_rank{rank}.pt")
    finally:
        shutdown()


if __name__ == "__main__":
    main()
