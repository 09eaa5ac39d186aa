"""Training: the train and eval steps with SAM + Adam, the state, the
reference's metrics, the epoch loop, checkpoints and the official WIDERFace
evaluation."""

from fdtpu_torch.train.metrics import average_precision, detection_metrics, f1_score  # noqa: F401
from fdtpu_torch.train.sam import global_norm, sam_gradients  # noqa: F401
from fdtpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from fdtpu_torch.train.step import make_eval_step, make_train_step  # noqa: F401
from fdtpu_torch.train.graphs import CapturedEvalStep, CapturedTrainStep  # noqa: F401
from fdtpu_torch.train.loop import Trainer  # noqa: F401
from fdtpu_torch.train.widerface_eval import (  # noqa: F401
    evaluate_widerface,
    write_official_predictions,
)
