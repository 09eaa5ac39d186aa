"""Interop with fdtpu: its Flax params carried across as torch state dicts."""

from fdtpu_torch.compat.from_fdtpu import poolresnet_state_dict  # noqa: F401
