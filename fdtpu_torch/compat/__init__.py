"""Interop with fdtpu: its Flax params and train state carried across."""

from fdtpu_torch.compat.from_fdtpu import poolresnet_state_dict, train_state_from_fdtpu  # noqa: F401
