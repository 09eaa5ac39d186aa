"""The first steps of resident training, followed in plain PyTorch.

From the benchmark's dataset, its initial weights and the run's seed this
works out again what the program's first steps do:

* the epoch's row order: every real row before the padding rows, the real
  ones shuffled by a uniform draw from a generator seeded by the hash of
  ``(seed + 2, epoch)``; a step takes the next ``B`` rows;
* each step's generator, seeded by the hash of ``(seed, step)``, from
  which the augmentation and then the dropout masks are drawn in the
  program's order (:mod:`perfbench.reference.augment`); without
  augmentation the images are ``u8 / 255`` and boxes under 10 px^2 drop;
* the family's targets and loss (its reference module's ``targets`` and
  ``loss``: the loss differentiated and the loss reported), SAM's two
  points (the gradient at ``w + rho g / (|g| + 1e-12)``, the same masks
  at both) and Adam (betas 0.9 / 0.999, eps 1e-8, the rate of the
  MultiStep schedule).

``precision`` computes the layers and the photometric chain in a lower
precision (the control) and
``fault`` plants a fault: ``"half"`` leaves the second half of each batch
out, the loss taken over the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import augment
from perfbench.reference.nn import FLOAT32, Masks, Precision

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def hashed_seed(seed: int, step: int) -> int:
    """The 63-bit hash of ``(seed, step)``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def epoch_rows(seed: int, epoch: int, n: int, batch: int, device) -> torch.Tensor:
    """The row order of a resident epoch over ``n`` images staged as whole
    batches (the padding rows repeat the last image and sort last)."""
    n_total = -(-n // batch) * batch
    gen = torch.Generator(device=device).manual_seed(hashed_seed(seed + 2, epoch))
    real = torch.arange(n_total, device=device) < n
    scores = torch.where(real, torch.rand((n_total,), generator=gen, device=device), 2.0)
    return torch.argsort(scores, stable=True)


def _inputs(ref, model, train, imgs_u8, boxes, masks, gen, precision):
    """Augmented float images and the family's targets."""
    b, h, w, _ = imgs_u8.shape
    if train["augment"]:
        if b >= 16:
            raise ValueError("the reference follows the per-sample augmentation (B < 16) only")
        d = augment.draw(gen, b, h, w, imgs_u8.device, train["rotate_device"])
        imgs, boxes, valid = augment.apply(imgs_u8, boxes, masks, d, precision)
    else:
        imgs = imgs_u8.float() / 255.0
        valid = masks & (boxes[..., 3] * boxes[..., 4] >= augment.MIN_AREA)
    return imgs, ref.targets(model, train, boxes, valid, (w, h), imgs.device)


def follow(ref, model: dict, train: dict, params0: dict, data: tuple, seed: int,
           steps: int = 3, precision: Precision = FLOAT32, fault: str | None = None) -> dict:
    """-> ``{"losses": [...], "first_grad": {name: g}, "change": {name:
    p_steps - p_0}, "rows": [...]}``. ``data`` is the benchmark's dataset
    ``(images u8, boxes, mask)``, on the host or on the parameters'
    device, where the steps run. Only Adam is followed: another optimizer
    raises."""
    if train["optimizer"] != "adam":
        raise ValueError(f"follow follows Adam only, not {train['optimizer']!r}")
    images, all_boxes, all_masks = data
    device = next(iter(params0.values())).device
    b = train["batch_size"]
    order = epoch_rows(seed, 0, images.shape[0], b, device)
    names = list(params0)
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "rows": []}
    for step in range(steps):
        rows = order[step * b:(step + 1) * b]
        out["rows"].append(rows)
        gen = torch.Generator(device=device).manual_seed(hashed_seed(seed, step))
        at = rows.to(images.device)
        imgs, target = _inputs(ref, model, train, images[at].to(device),
                               all_boxes[at].to(device), all_masks[at].to(device), gen, precision)
        real = torch.ones(b, device=device)
        if fault == "half":
            real[b // 2:] = 0.0
        masks = Masks(gen)

        def loss_at(p):
            masks.rewind()
            return ref.loss(ref.forward(p, imgs, model, precision, masks), target, real, train)

        leaves = [params[k].requires_grad_(True) for k in names]
        loss, reported = loss_at(params)
        grads = torch.autograd.grad(loss, leaves)
        scale = train["sam_rho"] / (torch.sqrt(sum((g ** 2).sum() for g in grads)) + 1e-12)
        moved = {k: (params[k] + g * scale).detach().requires_grad_(True)
                 for k, g in zip(names, grads)}
        sam_loss, _ = loss_at(moved)
        grads = torch.autograd.grad(sam_loss, [moved[k] for k in names])
        out["losses"].append(float(reported.detach()))
        if step == 0:
            out["first_grad"] = {k: g.detach().clone() for k, g in zip(names, grads)}
        t = step + 1
        lr = float(np.float32(train["learning_rate"]))
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(BETA1).add_((1 - BETA1) * g)
                v2[k].mul_(BETA2).add_((1 - BETA2) * g * g)
                denom = (v2[k] / (1 - BETA2 ** t)).sqrt() + EPS
                params[k] = params[k].detach() - lr * (m[k] / (1 - BETA1 ** t)) / denom
    out["change"] = {k: (params[k] - params0[k]).detach() for k in names}
    return out
