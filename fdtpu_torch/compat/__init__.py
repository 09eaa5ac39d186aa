"""Interop with fdtpu (its Flax params and train state carried across) and
with the reference (its TorchScript checkpoints imported)."""

from fdtpu_torch.compat.from_fdtpu import (  # noqa: F401
    mobilenetv3_state_dict,
    poolresnet_state_dict,
    resnet_state_dict,
    separable_state_dict,
    ssd_state_dict,
    state_dict_from_fdtpu,
    train_state_from_fdtpu,
)
from fdtpu_torch.compat.torch_import import (  # noqa: F401
    ReferenceLayoutGrid,
    load_reference_detector,
    load_torchscript_weights,
    pretrained_backbone_variables,
    read_torchscript_state_dict,
)
