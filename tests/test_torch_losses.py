"""The port's YOLO loss and grid target encoding against fdtpu's.

Tolerances: ``yolo_loss`` and its autograd gradient against fdtpu's value
and ``jax.grad``, rtol 1e-5 (float32; the sums run in another order).
``encode_grid_targets``: exactly equal, the same float32 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.core.grid import encode_grid_targets as jax_encode
from fdtpu.losses import yolo as jyolo
from fdtpu_torch.core.grid import encode_grid_targets
from fdtpu_torch.losses import COORD_WEIGHT, yolo_loss, yolo_loss_batch


def maps(b=3, s=5, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, s, s, 5)).astype(np.float32)
    pred[0, 0, 0, 3] = 0.0  # a zero width: the sqrt floor keeps the gradient finite
    gt = np.zeros((b, s, s, 5), np.float32)
    occ = rng.uniform(size=(b, s, s)) < 0.2
    gt[occ] = rng.uniform(0, 1, (occ.sum(), 5)).astype(np.float32)
    gt[occ, 0] = 1.0
    gt[0, 0, 0] = [1.0, 0.5, 0.5, 0.2, 0.3]
    return pred, gt


@pytest.mark.parametrize("swap", [False, True])
def test_yolo_loss_and_grad_match_fdtpu(swap):
    pred, gt = maps()
    jfn = lambda p: jnp.sum(jax.vmap(lambda a, b: jyolo.yolo_loss(a, b, swap))(p, jnp.asarray(gt)))
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    per_sample = yolo_loss(p, torch.from_numpy(gt), compat_swap_xy=swap)
    assert per_sample.shape == (3,)
    per_sample.sum().backward()
    np.testing.assert_allclose(per_sample.sum().item(), float(want), rtol=1e-5)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    for i in range(3):
        np.testing.assert_allclose(
            per_sample[i].item(), float(jyolo.yolo_loss(jnp.asarray(pred[i]), jnp.asarray(gt[i]), swap)),
            rtol=1e-5)


@pytest.mark.parametrize("average", [False, True])
def test_yolo_loss_batch_matches_fdtpu(average):
    pred, gt = maps(seed=1)
    got = yolo_loss_batch(torch.from_numpy(pred), torch.from_numpy(gt), average=average)
    want = jyolo.yolo_loss_batch(jnp.asarray(pred), jnp.asarray(gt), average=average)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert COORD_WEIGHT == jyolo.COORD_WEIGHT


@pytest.mark.parametrize("s,size", [(5, (160, 160)), (15, (320, 320)), (10, (480, 480)), (7, (200, 160))])
def test_encode_grid_targets_matches_fdtpu(s, size):
    w, h = size
    rng = np.random.default_rng(s)
    b, k = 4, 9
    boxes = np.zeros((b, k, 5), np.float32)
    boxes[..., 0] = 1.0
    boxes[..., 1] = rng.uniform(-30, w + 30, (b, k))  # some corners outside the image
    boxes[..., 2] = rng.uniform(-30, h + 30, (b, k))
    boxes[..., 3:5] = rng.uniform(1, 80, (b, k, 2))
    boxes[:, 5, 1:3] = boxes[:, 2, 1:3] + 0.25  # same cell as row 2: the later row wins
    mask = rng.uniform(size=(b, k)) > 0.25
    mask[:, 2] = mask[:, 5] = True
    mask[3] = False  # an image with no boxes
    got = encode_grid_targets(torch.from_numpy(boxes), torch.from_numpy(mask), s, size).numpy()
    want = np.asarray(jax.vmap(lambda bx, m: jax_encode(bx, m, s, size))(
        jnp.asarray(boxes), jnp.asarray(mask)))
    assert got.shape == (b, s, s, 5)
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()
