"""Torch's intra-op threads in the port's test processes.

Under pytest-xdist each worker is a process of its own, and torch's
intra-op pool takes one thread a core in every one of them: six workers on
eight cores run 48 compute threads, beside the rank processes that the
data-parallel and spatial tests spawn, and a test that waits on those ranks
runs out of its time. Imported by every ``tests/test_torch_*.py``, this
module gives an xdist worker ``max(1, os.cpu_count() // workers)`` threads;
a run without xdist keeps torch's default. The ranks the tests spawn take
their threads from ``OMP_NUM_THREADS`` (``test_torch_parallel.rank_env``).
"""

from __future__ import annotations

import os

import torch


def worker_threads() -> int | None:
    """The intra-op threads of an xdist worker, None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
