"""YOLO-grid target encoding and decoding (``fdtpu/core/grid.py``).

Maps are ``(..., S, S, 5)`` indexed ``[y_cell, x_cell]`` with channels
``(conf, x_rel, y_rel, w_norm, h_norm)``.
"""

from __future__ import annotations

import torch


def encode_grid_targets(
    boxes: torch.Tensor,
    mask: torch.Tensor,
    num_patches: int,
    image_size: tuple[int, int],
) -> torch.Tensor:
    """Encode padded pixel boxes ``(B, K, 5)`` rows ``[conf, x, y, w, h]``
    (top-left corner) with validity ``(B, K)`` into ``(B, S, S, 5)`` grid
    targets. Works on the batch directly.

    Semantics of the reference (``dataset.py:32-64``), as fdtpu keeps them:
    the cell comes from the top-left corner; the relative offset uses the
    unclamped cell index and the write uses the clamped one; when boxes
    share a cell the last one wins.
    """
    width, height = image_size
    s = num_patches
    x_patch = width / s
    y_patch = height / s

    conf, x, y, w, h = boxes.unbind(-1)
    i = torch.floor(x / x_patch)  # x-cell, unclamped
    j = torch.floor(y / y_patch)
    x_rel = (x - i * x_patch) / x_patch
    y_rel = (y - j * y_patch) / y_patch
    ic = i.clamp(0, s - 1).long()
    jc = j.clamp(0, s - 1).long()
    vals = torch.stack([conf, x_rel, y_rel, w / width, h / height], dim=-1)
    b = boxes.shape[0]
    return _scatter_last_wins(vals, jc * s + ic, mask, s * s).reshape(b, s, s, 5)


def _scatter_last_wins(
    vals: torch.Tensor, flat_idx: torch.Tensor, mask: torch.Tensor, num_cells: int
) -> torch.Tensor:
    """Scatter ``(B, K, 5)`` rows into ``(B, num_cells, 5)``; on collision the
    highest ``k`` wins. A scatter-amax of the row index into the cells (plus
    a dump slot for invalid rows), then a gather."""
    b, k, _ = vals.shape
    idx = torch.where(mask, flat_idx, num_cells)
    winner = torch.full((b, num_cells + 1), -1, dtype=torch.long, device=vals.device)
    rows = torch.arange(k, device=vals.device).expand(b, k)
    winner = winner.scatter_reduce(1, idx, rows, reduce="amax")[:, :num_cells]
    gathered = vals.gather(1, winner.clamp(0, k - 1)[..., None].expand(-1, -1, 5))
    return torch.where(winner[..., None] >= 0, gathered, 0.0).to(vals.dtype)


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
