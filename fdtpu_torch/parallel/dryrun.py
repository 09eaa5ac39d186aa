"""A data-parallel dry run (``__graft_entry__.py`` ``dryrun_multichip``):
``n`` ranks, one full SAM step each at tiny shapes, and the check that the
params came out identical on every rank.

    python -m fdtpu_torch.parallel.dryrun N [--spatial S] [--device cpu]

Each rank is a process: NCCL, one card a rank, on the card (the default;
``N`` must not exceed the visible cards), gloo with ``--device cpu``. The
steps: PoolResnet at 160 px (8 filters, 2 blocks) with augmentation,
dropout, SAM and Adam on, over a data x spatial grid of ranks
(``parallel/mesh.py``): ``S`` ranks share each image's height, by default
fdtpu's rule, 2 when ``N`` is even and at least 4, else 1 (data parallelism
alone), with fdtpu's global batch ``max(N, 2 * (N // S))``; then the SSD at
160 px (4 filters) with 0, 1 or 2 positives a rank, data-parallel over all
``N`` ranks, which exercises the weighted gradient reduction.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from fdtpu_torch.parallel.dp import broadcast_module, make_dp_train_step
from fdtpu_torch.parallel.mesh import data_shard, make_mesh
from fdtpu_torch.parallel.multihost import (
    initialize_multihost,
    launch_local_ranks,
    rank_device,
    shutdown,
)

SIZE = 160
RANK_TIMEOUT_S = 300


def default_spatial(n: int) -> int:
    """fdtpu's dry run's spatial axis: 2 when ``n`` is even and at least 4."""
    return 2 if n % 2 == 0 and n >= 4 else 1


def _global_batch(b: int, ssd: bool):
    """One global batch of ``b`` u8 frames, the same on every rank; for
    the SSD, ``i % 3`` faces in image ``i``."""
    rng = np.random.default_rng(1 if ssd else 0)
    images = rng.integers(0, 255, size=(b, SIZE, SIZE, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), np.float32)
    mask = np.zeros((b, 4), bool)
    for i in range(b):
        for j in range(i % 3 if ssd else 1):
            boxes[i, j] = [1.0, 12 + 30 * j, 20 + 25 * j, 40, 36]
            mask[i, j] = True
    return images, boxes, mask


def _params_identical(module) -> bool:
    """Rank 0's params broadcast to every rank and compared bit for bit."""
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return torch.equal(flat, ref)


def _one_step(name: str, module, rank: int, world: int, device, mesh=None) -> float:
    """One SAM step on this rank's share of the global batch: its slice of
    ``2 * world`` frames, or with ``mesh`` its data row's slice of fdtpu's
    spatial batch."""
    from fdtpu_torch.train.state import create_train_state
    from fdtpu_torch.utils.config import TrainConfig

    config = TrainConfig(use_sam=True, seed=rank)  # other seeds: the broadcast evens them
    state = create_train_state(module, config, 10)
    broadcast_module(state.module)
    step = make_dp_train_step(state.module, config, mesh=mesh, augment=name == "poolresnet")
    if mesh is None:
        arrays = _global_batch(2 * world, ssd=name == "ssd")
        lb = arrays[0].shape[0] // world
        arrays = [a[rank * lb:(rank + 1) * lb] for a in arrays]
    else:
        arrays = data_shard(mesh, *_global_batch(spatial_batch(*mesh.shape), ssd=False))
    batch = [torch.from_numpy(a).to(device) for a in arrays]
    state, scalars = step(state, *batch)
    loss = scalars["loss"].item()
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"rank {rank}: {name} step gave loss {loss}, step {state.step}")
    if not _params_identical(state.module):
        raise RuntimeError(f"rank {rank}: {name} params differ from rank 0's after the step")
    return loss


def spatial_batch(rows: int, spatial: int) -> int:
    """fdtpu's global batch on a ``rows x spatial`` mesh."""
    return max(rows * spatial, 2 * rows)


def _rank(rank: int, world: int, init_method: str, device: str, spatial: int) -> None:
    from fdtpu_torch.models import SSD, PoolResnet, ssd_patch_sizes

    device = rank_device(device, rank)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device=device)
    try:
        mesh = make_mesh(world, spatial) if spatial > 1 else None
        gen = torch.Generator().manual_seed(rank)
        pool = PoolResnet(8, (SIZE, SIZE), 10, 2, generator=gen).to(device)
        loss = _one_step("poolresnet", pool, rank, world, device, mesh)
        ssd = SSD(4, (SIZE, SIZE), ssd_patch_sizes((SIZE, SIZE)), generator=gen).to(device)
        ssd_loss = _one_step("ssd", ssd, rank, world, device)
        if rank == 0:
            shape = (world // spatial, spatial)
            batch = spatial_batch(*shape) if mesh else 2 * world
            print(f"dryrun OK: {world} ranks ({dist.get_backend()}, {device.type}), mesh "
                  f"{{'data': {shape[0]}, 'spatial': {shape[1]}}}, batch {batch}, loss "
                  f"{loss:.4f}, ssd batch {2 * world}, ssd loss {ssd_loss:.4f}, params identical "
                  "on every rank", flush=True)
    finally:
        shutdown()


def dryrun_multichip(n: int, device: str = "cuda", spatial: int | None = None) -> None:
    """Run the dry run on ``n`` ranks of this machine, ``spatial`` of them
    to an image (:func:`default_spatial` when None); raises if a rank
    fails, hangs past its timeout, or ends with params unlike rank 0's."""
    spatial = default_spatial(n) if spatial is None else spatial
    if spatial < 1 or n % spatial:
        raise ValueError(f"{n} ranks do not divide into a spatial axis of {spatial}")
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} ranks need {n} cards; {torch.cuda.device_count()} visible "
                           "(pass device='cpu' for gloo ranks)")
    launch_local_ranks(_rank, n, args=(device, spatial), timeout=RANK_TIMEOUT_S)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--spatial", type=int, default=None,
                   help="ranks to an image (default: 2 when N is even and at least 4, else 1)")
    p.add_argument("--device", default="cuda", help="cuda (default; NCCL) or cpu (gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.spatial)


if __name__ == "__main__":
    main()
