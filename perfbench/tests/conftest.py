"""Under pytest-xdist each worker runs torch at its share of the host's
cores, so that the workers' intra-op threads do not oversubscribe it."""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
