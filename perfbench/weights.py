"""Weights made on the device from the seed, in one large draw, for both
the program and the plain reference.

A reference names every parameter with its shape and initialiser
(``param_specs``). One uniform draw of all the parameters' elements
comes from a generator on the device; each parameter takes its slice:
``lecun_normal`` is a normal truncated at two standard deviations (by its
inverse distribution function, so the uniform draw serves) of variance
``1 / fan_in``, ``torch_uniform`` is ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``, ``zeros`` is 0 and ``ones`` is 1 (a BatchNorm's scale
or running variance). Every parameter takes its slice whatever its
initialiser, so a parameter's draw depends on its place in the specs
alone. Float32, the type the program keeps its parameters in (its
serving copy casts them itself).
"""

from __future__ import annotations

import math

import torch

from perfbench.data import sub_seed

_SQRT2 = math.sqrt(2.0)


def draw(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=gen, device=device)
    # a standard normal truncated to [-2, 2]: Phi^-1(Phi(-2) + u (Phi(2) - Phi(-2)))
    lo = 0.5 * math.erfc(2.0 / _SQRT2)
    trunc = _SQRT2 * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    trunc_std = 0.87962566103423978  # the std of a unit normal truncated to [-2, 2]
    out, at = {}, 0
    for name, shape, (kind, fan_in) in specs:
        n = math.prod(shape)
        if kind == "lecun_normal":
            v = trunc[at:at + n] * (math.sqrt(1.0 / fan_in) / trunc_std)
        elif kind == "torch_uniform":
            v = (2.0 * u[at:at + n] - 1.0) / math.sqrt(fan_in)
        elif kind == "zeros":
            v = torch.zeros(n, device=device)
        elif kind == "ones":
            v = torch.ones(n, device=device)
        else:
            raise ValueError(f"unknown initialiser {kind!r}")
        out[name] = v.reshape(shape).clone()
        at += n
    return out


def center_scores(ref, params: dict, model: dict, frames_u8: torch.Tensor,
                  eligible_per_frame: float) -> None:
    """Shift each head's score bias in ``params`` (the entry that its
    reference's ``score_heads`` names) so that, over ``frames_u8``, about
    ``eligible_per_frame`` of a frame's candidates score above 0.5, in
    proportion to each head's candidates: each head's candidate logits
    are moved so that their ``1 - eligible / N`` quantile sits at 0. Trained maps are that sparse; random weights put a frame's
    scores anywhere, all on one side of 0.5 for some seeds. By the float32
    reference, before the program is built."""
    images = frames_u8.float() / 255.0
    for _ in range(6):
        with torch.no_grad():
            rows = ref.forward(params, images, model)
        rows = rows.reshape(rows.shape[0], -1, ref.ROW)
        q = 1.0 - eligible_per_frame / rows.shape[1]
        worst = 0.0
        for name, cands, entry in ref.score_heads(model):
            p = rows[:, cands, 0].clamp(1e-6, 1.0 - 1e-6)
            at = float(torch.quantile(torch.logit(p).flatten().double(), q))
            params[name][entry] -= at
            worst = max(worst, abs(at))
        if worst < 0.05:
            return
