"""Data parallelism over ``torch.distributed`` (``fdtpu/parallel/``): one
process a rank, NCCL between cards, gloo on the CPU; a data x spatial grid
of ranks (``mesh.py``) that also shards the image height, with the row-halo
exchange of ``halo.py`` and every family's spatial forward (``spatial.py``)."""

from fdtpu_torch.parallel.dp import (  # noqa: F401
    barrier,
    batch_norm_over,
    broadcast_module,
    global_loss_scale,
    grad_all_reduce,
    make_dp_eval_step,
    make_dp_train_step,
    mean_buffers,
    reduce_loss_sum,
    trainer_route,
    weighted_metric_reduce,
)
from fdtpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_shard,
    make_mesh,
    row_split,
    shard_rows,
)
from fdtpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    launch_local_ranks,
    rank_device,
    shutdown,
    torchrun_environment,
)
from fdtpu_torch.parallel.spatial import (  # noqa: F401
    MobileNetV3Plan,
    PoolResnetPlan,
    SSDPlan,
    mobilenetv3_plan,
    poolresnet_plan,
    spatial_forward,
    spatial_plan,
    ssd_plan,
)
