"""Interop with fdtpu: its Flax params and train state carried across."""

from fdtpu_torch.compat.from_fdtpu import (  # noqa: F401
    poolresnet_state_dict,
    ssd_state_dict,
    state_dict_from_fdtpu,
    train_state_from_fdtpu,
)
