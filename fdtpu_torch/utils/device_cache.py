"""A cache for functions that make constant tensors on a device."""

from __future__ import annotations

import functools


def device_cache(fn):
    """``functools.lru_cache`` for a function that makes constant tensors
    on a device, except while a fake-tensor trace runs (``torch.export``):
    the tensors made then are fake, so that call is not cached and a later
    eager call still gets real tensors."""
    cached = functools.lru_cache(maxsize=32)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        from torch._guards import detect_fake_mode

        return fn(*args) if detect_fake_mode() is not None else cached(*args)

    wrapper.cache_clear = cached.cache_clear
    return wrapper
