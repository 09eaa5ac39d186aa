"""The data x spatial grid of ranks (``fdtpu/parallel/mesh.py``).

fdtpu lays ``devices.reshape(n // spatial, spatial)`` under the axes
``("data", "spatial")``: the batch is sharded over ``data`` and, with
``spatial > 1``, the image height over ``spatial``. Here every device is a
rank of ``torch.distributed`` and the same layout numbers them: rank ``r``
sits at data index ``r // spatial`` and spatial index ``r % spatial``, the
spatial axis fastest. A rank reduces over two process groups: its *data
group* (the ranks of its spatial index, one a data row) and its *spatial
group* (the ranks of its data row). ``parallel/halo.py`` moves rows within a
spatial group; ``train/step.py`` reduces gradients over the whole mesh and
the reported scalars over the data group.

Rows of a dimension are split over the ranks ceil-first, as
``numpy.array_split`` splits them: 15 rows over 2 ranks are 8 + 7.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, spatial)`` grid of ranks.

    ``group`` holds every rank of the mesh, ``data_group`` the ranks of
    this rank's spatial index (the data axis), ``spatial_group`` the ranks
    of this rank's data row (the spatial axis). The groups are None in a
    mesh made without a process group (:func:`mesh_layout`)."""

    shape: tuple[int, int]  # (data, spatial)
    rank: int
    group: object = None
    data_group: object = None
    spatial_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def spatial_index(self) -> int:
        return self.rank % self.shape[1]

    @property
    def spatial(self) -> int:
        return self.shape[1]


def row_split(n: int, parts: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` rows of each of ``parts`` ranks over ``n``
    rows, ceil-first (``numpy.array_split``): 15 over 2 is 8 + 7, 10 over 4
    is 3 + 3 + 2 + 2."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        out.append((start, stop))
        start = stop
    return out


def _check_layout(world: int, spatial: int) -> None:
    if spatial < 1 or world < 1 or world % spatial:
        raise ValueError(f"a mesh of {world} ranks does not divide into a spatial axis of "
                         f"{spatial}")


def mesh_layout(world: int, spatial: int, rank: int) -> Mesh:
    """The mesh coordinates of ``rank`` alone, without process groups."""
    _check_layout(world, spatial)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a mesh of {world} ranks")
    return Mesh((world // spatial, spatial), rank)


def make_mesh(world: int | None = None, spatial: int = 1) -> Mesh | None:
    """fdtpu's ``make_mesh(n, spatial)`` over the first ``world`` ranks of
    the default process group (all of them when None), which must be
    initialised.

    Every rank of the default group must call it, in the same order as
    its other group calls: each rank creates every group of the mesh
    (``dist.new_group`` hangs otherwise). A rank outside the first
    ``world`` gets None. Raises ``ValueError`` when the group has fewer
    than ``world`` ranks or ``world`` does not divide by ``spatial``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(fdtpu_torch.parallel.initialize_multihost)")
    size, rank = dist.get_world_size(), dist.get_rank()
    world = size if world is None else world
    if world > size:
        raise ValueError(f"make_mesh needs {world} ranks but the process group has {size}")
    _check_layout(world, spatial)
    rows = world // spatial
    group = dist.group.WORLD if world == size else dist.new_group(list(range(world)))
    data_groups = [dist.new_group([d * spatial + s for d in range(rows)]) for s in range(spatial)]
    spatial_groups = [dist.new_group([d * spatial + s for s in range(spatial)])
                      for d in range(rows)]
    if rank >= world:
        return None
    mesh = mesh_layout(world, spatial, rank)
    return dataclasses.replace(mesh, group=group, data_group=data_groups[mesh.spatial_index],
                               spatial_group=spatial_groups[mesh.data_index])


def data_shard(mesh: Mesh, *arrays):
    """fdtpu's batch sharding over ``data``: this rank's data row of each
    batch-leading array (the whole row, whatever the spatial index)."""
    rows = mesh.shape[0]
    out = []
    for a in arrays:
        if a.shape[0] % rows:
            raise ValueError(f"a batch of {a.shape[0]} does not split over {rows} data rows")
        lb = a.shape[0] // rows
        out.append(a[mesh.data_index * lb:(mesh.data_index + 1) * lb])
    return tuple(out)


def shard_rows(images: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """fdtpu's ``shard_batch_arrays(..., spatial_image_dim=1)`` for one
    ``(B, H, W, C)`` batch: this rank's data row of the batch and its rows
    of the height."""
    (images,) = data_shard(mesh, images)
    start, stop = row_split(images.shape[1], mesh.spatial)[mesh.spatial_index]
    return images[:, start:stop]
