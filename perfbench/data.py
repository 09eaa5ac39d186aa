"""The one generator of the benchmark's inputs: synthetic face images
made on the device from the seed, and the in-memory data source that
hands them to the program's feed.

An image is uniform noise in [0, 90) with elliptic "faces" painted over
it in a skin tone drawn from [170, 255) a channel (the idea of the
program's ``make_synthetic_widerface``, written straight to arrays). The
faces an image follow a geometric law of the mix's mean (WIDERFace has
393,703 faces over 32,203 images, about 12), capped at the capacity; a
face's width is log-uniform in [12, 160] px at 480 px (scaled with the
side), its height 1.0-1.4 times that, its top-left corner uniform where it
fits. Boxes are rows ``[1, x, y, w, h]`` in whole pixels, as the program's
source rounds them. The same seed gives the same images on every card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_STREAMS = {"train": 0, "weights": 1, "frames": 2}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of one of the run's streams (:data:`SEED_STREAMS`)."""
    state = np.random.SeedSequence([int(seed), SEED_STREAMS[stream]]).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def faces(seed: int, stream: str, n: int, size: int, capacity: int, faces_mean: float,
          device, chunk: int = 64):
    """-> ``(images (n, size, size, 3) uint8, boxes (n, capacity, 5) float32,
    mask (n, capacity) bool)`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    # faces an image: 1 + geometric(p) has mean 1 / p
    p = 1.0 / faces_mean
    count = (1 + torch.floor(torch.log(rand(n).clamp_min(1e-12)) / math.log(1.0 - p))) \
        .clamp(max=capacity).long()
    scale = size / 480.0
    lo, hi = math.log(12 * scale), math.log(160 * scale)
    fw = torch.exp(lo + rand(n, capacity) * (hi - lo)).round().clamp(2, size)
    fh = (fw * (1.0 + 0.4 * rand(n, capacity))).round().clamp(2, size)
    fx = (rand(n, capacity) * (size - fw)).floor()
    fy = (rand(n, capacity) * (size - fh)).floor()
    skin = (170 + torch.floor(85 * rand(n, capacity, 3))).to(torch.uint8)
    mask = torch.arange(capacity, device=device)[None, :] < count[:, None]
    boxes = torch.stack([torch.ones_like(fx), fx, fy, fw, fh], dim=-1) * mask[..., None]

    images = torch.randint(0, 90, (n, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    axis = torch.arange(size, dtype=torch.float32, device=device) + 0.5
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        img = images[sl]
        for k in range(int(count[sl].max())):
            rx, ry = fw[sl, k] / 2, fh[sl, k] / 2
            dx = ((axis[None, :] - fx[sl, k, None] - rx[:, None]) / rx[:, None]) ** 2
            dy = ((axis[None, :] - fy[sl, k, None] - ry[:, None]) / ry[:, None]) ** 2
            inside = (dy[:, :, None] + dx[:, None, :] <= 1.0) & mask[sl, k, None, None]
            img = torch.where(inside[..., None], skin[sl, k, None, None, :], img)
        images[sl] = img
    return images, boxes, mask


class ArraySource:
    """The train feed's data source over host arrays, the interface of the
    program's ``WIDERFaceDataSource``: ``len``, ``get(i)`` and
    ``get_batch(indices)`` -> ``(image (H, W, 3) uint8, boxes (K, 5)
    float32, mask (K,) bool)``. No host rotation (``rotate_prob`` 0)."""

    rotate_prob = 0.0

    def __init__(self, images: np.ndarray, boxes: np.ndarray, mask: np.ndarray):
        self.images, self.boxes, self.mask = images, boxes, mask

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int):
        return self.images[index], self.boxes[index], self.mask[index]

    def get_batch(self, indices) -> list:
        return [self.get(int(i)) for i in indices]
