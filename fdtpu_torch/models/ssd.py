"""SSD multi-scale detector (``fdtpu/models/ssd.py``).

A stride-2 stem conv, a 9-block feature extractor with two max-pools (480 ->
60), then one block per scale (a max-pool between consecutive scales), each
with a position-wise ``Linear(ch -> 5)`` head (fdtpu's ``Dense`` over NHWC
channels); the heads' outputs are flattened NHWC row-major to
``(B, ps², 5)``, cast to float32 and concatenated, the sigmoid goes on the
scores only, and the priors are applied: normalized [0, 1] prior-space
boxes ``(B, N, 5)``.

Channels: scale ``i`` reads ``min(4f * 2^i, 16f)`` and writes
``min(2 * in, 16f)``. Weights start from torch's default init
(``torch_init=True``, fdtpu's SSD default: with LeCun-normal kernels and
zero biases every initial score sits at 0.5 and hard-negative mining has
nothing to rank; fdtpu measured SSD training collapse under it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fdtpu_torch.core.priors import apply_priors, priors_on
from fdtpu_torch.models.layers import DropoutMasks, SSDResidualBlock, conv, ssd_init_


def ssd_patch_sizes(input_shape: tuple[int, int]) -> tuple[int, ...]:
    """The grid sizes of the SSD geometry for a square input: stem /2, two
    extractor pools /4, then one pool between consecutive scales. 480 ->
    (60, 30, 15, 7), the reference's table; 640 -> (80, 40, 20, 10)."""
    base = input_shape[0] // 8
    return (base, base // 2, base // 4, base // 8)


class SSD(nn.Module):
    """Args mirror fdtpu's ``SSD``; submodules: ``stem``, ``extractor.{0..8}``,
    ``scales.{0..3}`` (:class:`~fdtpu_torch.models.layers.SSDResidualBlock`)
    and ``heads.{0..3}``.

    ``forward`` takes ``(B, H, W, 3)`` images and returns ``(B, N, 5)``
    float32 rows ``[score, x, y, w, h]``, normalized. It computes in
    ``compute_dtype``, or in the dtype of the module's weights when that is
    None, as :class:`~fdtpu_torch.models.poolresnet.PoolResnet` does.
    Dropout applies only when ``forward`` is given dropout masks.
    """

    def __init__(
        self,
        filters: int,
        input_shape: tuple[int, int],  # (height, width)
        patch_sizes: tuple[int, ...] = (60, 30, 15, 7),
        dropout: float = 0.25,
        torch_init: bool = True,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_shape = tuple(input_shape)
        self.patch_sizes = tuple(patch_sizes)
        f, max_filters = filters, 16 * filters

        def block(cin, cout, pool=False):
            return SSDResidualBlock(cin, cout, use_max_pool=pool, dropout=dropout,
                                    torch_init=torch_init, generator=generator)

        self.stem = nn.Conv2d(3, f, 3, stride=2, padding=1)
        self.extractor = nn.ModuleList(
            [block(f, 2 * f, True), block(2 * f, 2 * f, True)]
            + [block(2 * f, 2 * f) for _ in range(6)]
            + [block(2 * f, 4 * f)]
        )
        scales, heads = [], []
        for i in range(len(self.patch_sizes)):
            in_f = min(4 * f * 2**i, max_filters)
            out_f = min(2 * in_f, max_filters)
            scales.append(block(in_f, out_f, i != 0))
            heads.append(nn.Linear(out_f, 5))
        self.scales = nn.ModuleList(scales)
        self.heads = nn.ModuleList(heads)
        for layer in (self.stem, *self.heads):
            ssd_init_(layer, torch_init, generator)

    def forward(self, images: torch.Tensor, masks: DropoutMasks | None = None) -> torch.Tensor:
        # an NHWC tensor seen as NCHW is in channels_last memory format
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype or self.stem.weight.dtype)
        x = conv(self.stem, x)
        for block in self.extractor:
            x = block(x, masks)
        b = x.shape[0]
        outs = []
        for ps, block, head in zip(self.patch_sizes, self.scales, self.heads):
            x = block(x, masks)
            if x.shape[2:] != (ps, ps):
                raise ValueError(f"spatial {tuple(x.shape[2:])} != patch size {ps}; "
                                 "use ssd_patch_sizes(input_shape)")
            # position-wise head over the channels, NHWC row-major
            z = F.linear(x.permute(0, 2, 3, 1), head.weight.to(x.dtype), head.bias.to(x.dtype))
            outs.append(z.reshape(b, ps * ps, 5).float())
        out = torch.cat(outs, dim=1)
        out = torch.cat([torch.sigmoid(out[..., :1]), out[..., 1:]], dim=-1)
        priors, scales = priors_on(self.patch_sizes, out.device)
        return apply_priors(out, priors, scales)
