"""Data parallelism over ``torch.distributed`` (``fdtpu/parallel/``): one
process a rank, NCCL between cards, gloo on the CPU. No spatial axis."""

from fdtpu_torch.parallel.dp import (  # noqa: F401
    barrier,
    broadcast_module,
    grad_all_reduce,
    make_dp_eval_step,
    make_dp_train_step,
    mean_buffers,
    reduce_loss_sum,
    weighted_metric_reduce,
)
from fdtpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    launch_local_ranks,
    rank_device,
    shutdown,
    torchrun_environment,
)
