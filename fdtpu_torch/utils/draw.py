"""Box visualization, a copy of the PIL-only ``fdtpu/utils/draw.py``
(the reference's ``draw_bbx``): PIL rectangles, thin outline for boxes under
15px, saved to ``imgs/<name>.png`` or shown."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def draw_bbx(
    img,
    bbxs,
    save_name: str = "image",
    show: bool = False,
    out_dir: str | Path = "imgs",
    mask=None,
):
    """Draw ``(K, 5)`` ``[score, x, y, w, h]`` (or ``(K, 4)`` xywh) boxes.

    ``img`` may be a float array in [0, 1] (as produced by the pipeline), a
    uint8 array, or a PIL image. ``mask`` drops padded rows (the reference
    receives ragged lists instead).
    """
    from PIL import Image, ImageDraw

    if not isinstance(img, Image.Image):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        img = Image.fromarray(arr)
    bbxs = np.asarray(bbxs)
    if mask is not None:
        bbxs = bbxs[np.asarray(mask)]
    draw = ImageDraw.Draw(img)
    for b in bbxs:
        if len(b) == 5:
            b = b[1:]
        x, y, w, h = float(b[0]), float(b[1]), float(b[2]), float(b[3])
        # SSD location outputs are unconstrained (no sigmoid on bbx,
        # SSD.py:246), so early-training boxes can have negative extent —
        # clamp instead of letting PIL raise
        w, h = max(w, 0.0), max(h, 0.0)
        width = 1 if (w <= 15 or h <= 15) else 3  # utils.py:195-203
        draw.rectangle((x, y, x + w, y + h), outline="blue", width=width)
    if show:
        img.show()
    else:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        img.save(out / f"{save_name}.png")
    return img
