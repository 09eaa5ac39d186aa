"""YOLO-grid decoding (``fdtpu/core/grid.py:decode_grid``).

Maps are ``(..., S, S, 5)`` indexed ``[y_cell, x_cell]`` with channels
``(conf, x_rel, y_rel, w_norm, h_norm)``. Target encoding belongs to
training and is not ported yet.
"""

from __future__ import annotations

import torch


def decode_grid(
    fm: torch.Tensor,
    num_patches: int,
    image_size: tuple[int, int],
) -> torch.Tensor:
    """Decode a ``(..., S, S, 5)`` grid map to ``(..., S*S, 5)`` pixel-space
    candidates ``[conf, x, y, w, h]``; every cell becomes a candidate::

        x_pix = x_rel * x_patch + x_cell * x_patch
        y_pix = y_rel * y_patch + y_cell * y_patch
        w_pix = w_norm * width;  h_pix = h_norm * height

    Each product is taken in the map's dtype, like fdtpu's weakly typed
    Python-float scales.
    """
    width, height = image_size
    s = num_patches
    x_patch = width / s
    y_patch = height / s

    cells = torch.arange(s, dtype=fm.dtype, device=fm.device)
    conf = fm[..., 0]
    x = fm[..., 1] * x_patch + (cells * x_patch)[None, :]
    y = fm[..., 2] * y_patch + (cells * y_patch)[:, None]
    w = fm[..., 3] * width
    h = fm[..., 4] * height
    cand = torch.stack([conf, x, y, w, h], dim=-1)
    return cand.reshape(fm.shape[:-3] + (s * s, 5))
