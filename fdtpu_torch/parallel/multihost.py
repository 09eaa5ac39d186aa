"""Process-group bootstrap (``fdtpu/parallel/multihost.py``), over
``torch.distributed``.

fdtpu initialises ``jax.distributed`` from a pod's environment and, inside
one process, lays a mesh over the devices it sees. Here every data-parallel
rank is a process of its own, with one card (or the CPU): torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) describes the group, or the caller names it, and
:func:`launch_local_ranks` starts the ranks of one machine itself.

``global_batch_from_local`` has no counterpart: it assembles fdtpu's global
arrays from each process's slice of the batch, and here each rank keeps its
own slice (``BatchLoader(process_shard=(rank, world))``) and steps on it.
The mesh of ``fdtpu/parallel/mesh.py`` is ``parallel/mesh.py``'s grid of
ranks.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
TORCHRUN_KEYS = ("RANK", "WORLD_SIZE")


def torchrun_environment() -> bool:
    """True in a process that torchrun (or any launcher setting its
    variables) started as a rank of a group."""
    return all(k in os.environ for k in TORCHRUN_KEYS)


def rank_device(device: torch.device | str, local_rank: int) -> torch.device:
    """The device a rank runs on: ``cuda`` becomes the rank's own card
    ``cuda:<local_rank>``; a device with an index, or the CPU, stays."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def initialize_multihost(
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
    init_method: str | None = None,
    device: torch.device | str = "cuda",
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the default process group; returns True when this call or an
    earlier one initialised it, False for a lone process (a no-op).

    With no arguments the group comes from torchrun's environment
    (``init_method="env://"``); without that environment there is no
    group and the call returns False. Explicit arguments name it instead,
    e.g. ``init_method="file:///tmp/x"`` with a rank and a world size.
    The backend is NCCL when ``device`` is a CUDA device, gloo for
    ``"cpu"``; ``backend`` overrides that choice (gloo also all-reduces
    and broadcasts CUDA tensors, staging them through the host). On a
    CUDA device the rank's card becomes the current device: ``device``'s
    index, else ``local_rank``. Every collective of the group fails after
    ``timeout``.
    """
    if dist.is_initialized():
        return True
    if world_size is None:
        if not torchrun_environment():
            return False  # no cluster environment: one process, no group
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        world_size=world_size,
        rank=rank,
        timeout=timeout,
    )
    return True


def shutdown() -> None:
    """Leave the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def launch_local_ranks(fn: Callable, world: int, args: tuple = (),
                       timeout: float | None = None) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes
    of this machine (start method ``spawn``), with a ``file://``
    rendezvous in a private temporary directory, and wait for all of them.

    ``fn`` must be importable by name (a module-level function). A rank
    that raises or exits non-zero ends the others and raises here; so does
    ``timeout`` (seconds, None for no limit) running out. ``fn`` calls
    :func:`initialize_multihost` with the ``init_method`` it is given.
    """
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="fdtpu_rendezvous_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    try:
        ctx = mp.start_processes(fn, args=(world, init_method, *args), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        # join raises (and ends the other ranks) as soon as one fails
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def start_entry_ranks(args, rank_fn: Callable, argv) -> bool:
    """``--data-parallel`` and ``--multihost`` of a training entry point
    (fdtpu's ``train_model.py:64-125``). Returns True when this process
    trains, False when it launched the ranks itself and they have finished.

    * ``--multihost`` implies ``--data-parallel -1``.
    * Under torchrun (its ``RANK`` and ``WORLD_SIZE`` set) with
      ``--data-parallel`` other than 0: join torchrun's group (NCCL on the
      card, gloo with ``--device cpu``); N must equal its world size, -1
      takes it. The rank trains on its own card.
    * Alone, ``--data-parallel N`` (N > 1) launches N local ranks, one a
      card (gloo ranks with ``--device cpu``), each running
      ``rank_fn(rank, world, init_method, argv)``; -1 launches one a
      visible card (one process on one card, or on the CPU).

    ``args.data_parallel`` and ``args.device`` are set to the rank's.
    """
    if args.multihost and args.data_parallel == 0:
        args.data_parallel = -1
    if args.data_parallel in (0, 1):
        return True
    cuda = torch.device(args.device).type == "cuda"
    if torchrun_environment():
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        args.device = str(rank_device(args.device, local_rank))
        initialize_multihost(device=args.device)
        world = dist.get_world_size()
        if args.data_parallel not in (-1, world):
            raise SystemExit(f"--data-parallel {args.data_parallel} but torchrun started "
                             f"{world} ranks")
        args.data_parallel = world
        return True
    if args.data_parallel == -1:
        args.data_parallel = torch.cuda.device_count() if cuda else 1
        if args.data_parallel <= 1:
            args.data_parallel = 0  # one card: one process
            return True
    if cuda and args.data_parallel > torch.cuda.device_count():
        raise SystemExit(f"--data-parallel {args.data_parallel} needs one card a rank; "
                         f"{torch.cuda.device_count()} visible")
    launch_local_ranks(rank_fn, args.data_parallel, args=(argv,))
    return False


def join_entry_rank(args, rank: int, world: int, init_method: str) -> None:
    """In a rank that :func:`start_entry_ranks` launched: take the rank's
    device and join the group."""
    args.device = str(rank_device(args.device, rank))
    args.data_parallel = world
    initialize_multihost(rank=rank, world_size=world, init_method=init_method,
                         device=args.device)


def entry_process_shard(args) -> tuple[int, int] | None:
    """The loaders' ``process_shard`` for an entry point's parsed flags."""
    if args.data_parallel in (0, 1):
        return None
    return dist.get_rank(), dist.get_world_size()
