"""RetinaFace-R50 as ``load_checkpoint --model retinaface`` builds it: a
``RetinaFaceConfig`` of the configuration's ``cfg_re50`` keys. Served
only: the program does not train it."""

from __future__ import annotations

MODEL = "retinaface"  # the name the program's build_model takes


def model_config(config: dict):
    """The program's ``RetinaFaceConfig`` of a configuration."""
    from fdtpu_torch.utils.config import RetinaFaceConfig

    m, d = config["model"], config["detector"]
    return RetinaFaceConfig(input_shape=tuple(m["input_shape"]),
                            in_channels=tuple(m["in_channels"]), out_channel=m["out_channel"],
                            min_sizes=tuple(tuple(s) for s in m["min_sizes"]),
                            steps=tuple(m["steps"]), variance=tuple(m["variance"]),
                            clip=m["clip"], mean=tuple(m["mean"]),
                            probability_threshold=d["probability_threshold"],
                            iou_threshold=d["iou_threshold"], nms_capacity=d["nms_capacity"],
                            dtype=config["compute_dtype"])


def loss_kwargs(config: dict) -> dict:
    """None: RetinaFace's training is not ported."""
    raise NotImplementedError("RetinaFace's training is not ported: no train cell runs it")
