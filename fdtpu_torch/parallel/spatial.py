"""The forward of every family of the zoo over the spatial axis: each rank
of a spatial group computes the output rows it owns of every layer, through
``parallel/halo.py``'s exchanges, and the rows of the output maps are
gathered into the whole maps on every rank.

It walks the model's own submodules with their own parameters, so a
``state_dict`` loads and saves as it does for the model, and the math is the
model's forward. What a shard's height would get wrong is decided by a plan
from the global height: whether a block pools (a block pools while *its
input's* height exceeds ``pool_until``), the ``"SAME"`` pads of
MobileNetV3's strided layers, and the SSD's patch-size check. The forward
runs each block's layers, dropout, skip and pool itself.

* PoolResnet, Resnet and SeparableCNN (:func:`poolresnet_plan`): the stem,
  each block's exchange (a ``ResidualBlock``'s two 3x3 convolutions share
  one; a ``SeparableResidualBlock``'s 1x1 convolutions need none and its
  depthwise 3x3 one) and pool, the head; the grid's rows are gathered.
* MobileNetV3 (:func:`mobilenetv3_plan`): the stem and every depthwise
  convolution padded ``"SAME"`` on the global height, the 1x1 convolutions
  without exchange, the k3/p1 head, the grid's rows gathered. A
  squeeze-excite's mean over H and W is a per-sample, per-channel sum over
  the rank's rows, summed over the spatial group and divided by the global
  H x W. In ``train`` mode every BatchNorm sums its statistics over the
  whole mesh (``dp.batch_norm_over``): the global batch's, as fdtpu's GSPMD
  step normalises.
* The SSD (:func:`ssd_plan`): the k3/s2/p1 stem; each block's ``conv1`` and
  ``conv2`` take their own exchange (one table: the same geometry), its 1x1
  ``skip`` none, its pool the pool's; each scale's position-wise head runs
  on the rank's rows, and each scale's rows are gathered and flattened in
  the model's row-major order.

Dropout draws its ``(B, C, 1, 1)`` channel masks from the step's generator;
every rank of a spatial group draws the same ones, as its step seeds the
generator with the data index. With one rank in the mesh, every exchange is
the identity and every layer the model's own call: the forward is the
model's, op for op.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fdtpu_torch.core.priors import apply_priors, priors_on
from fdtpu_torch.models.layers import (
    DropoutMasks,
    SeparableResidualBlock,
    conv,
    conv_same,
    leaky_relu,
    max_pool_2x2,
)
from fdtpu_torch.models.mobilenetv3 import MobileNetV3Backbone, hard_sigmoid, hard_swish
from fdtpu_torch.models.poolresnet import PoolResnet
from fdtpu_torch.models.ssd import SSD
from fdtpu_torch.parallel.dp import batch_norm_over
from fdtpu_torch.parallel.halo import (
    Exchange,
    conv_exchange,
    conv_rows,
    gather_rows,
    halo,
    pool_exchange,
    same_exchange,
    sum_over,
)
from fdtpu_torch.parallel.mesh import Mesh

Stage = tuple[Exchange, Exchange | None]  # a block's convolutions' exchange, and its pool's


@dataclasses.dataclass(frozen=True)
class PoolResnetPlan:
    """Every exchange of one forward of PoolResnet, Resnet or SeparableCNN
    at one image height over ``parts`` spatial ranks: the stem's (its
    ``own_in`` is the image's rows), each block's (its convolution's, and
    its pool's or None), the head's (its ``own_out`` is the grid's rows)."""

    stem: Exchange
    blocks: tuple[Stage, ...]
    head: Exchange

    @property
    def image_rows(self) -> tuple[tuple[int, int], ...]:
        return self.stem.own_in


@dataclasses.dataclass(frozen=True)
class MobileNetV3Plan:
    """MobileNetV3's exchanges: the stem's, each block's depthwise
    convolution's (``"SAME"`` on the global height) and the head's."""

    stem: Exchange
    blocks: tuple[Exchange, ...]
    head: Exchange

    @property
    def image_rows(self) -> tuple[tuple[int, int], ...]:
        return self.stem.own_in


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    """The SSD's exchanges: the stem's, each extractor block's and each
    scale block's (its convolutions', and its pool's or None)."""

    stem: Exchange
    extractor: tuple[Stage, ...]
    scales: tuple[Stage, ...]

    @property
    def image_rows(self) -> tuple[tuple[int, int], ...]:
        return self.stem.own_in


def _stage_out(stage: Stage) -> Exchange:
    convs, pool = stage
    return pool or convs


def poolresnet_plan(module: PoolResnet, height: int, parts: int) -> PoolResnetPlan:
    """The exchanges of ``module``'s forward (PoolResnet, or Resnet or
    SeparableCNN on its body) on images ``height`` rows high, each block's
    pool decided on the global height."""
    stem = conv_exchange(height, module.conv1, parts)
    n, blocks = stem.n_out, []
    for block in module.residual_blocks:
        window = block.depthwise_conv if isinstance(block, SeparableResidualBlock) else block.conv1
        convs = conv_exchange(n, window, parts)
        pool = pool_exchange(n, parts) if n > block.pool_until else None
        blocks.append((convs, pool))
        n = pool.n_out if pool else n
    return PoolResnetPlan(stem, tuple(blocks), conv_exchange(n, module.out, parts))


def mobilenetv3_plan(module: MobileNetV3Backbone, height: int, parts: int) -> MobileNetV3Plan:
    """The exchanges of MobileNetV3's forward on images ``height`` rows
    high: every ``"SAME"`` pad from the global height."""
    stem = same_exchange(height, module.conv_stem, parts)
    n, blocks = stem.n_out, []
    for block in module.blocks:
        blocks.append(same_exchange(n, block.conv_dw, parts))
        n = blocks[-1].n_out
    return MobileNetV3Plan(stem, tuple(blocks), conv_exchange(n, module.head, parts))


def ssd_plan(module: SSD, height: int, parts: int) -> SSDPlan:
    """The exchanges of the SSD's forward on images ``height`` rows high.
    Raises ``ValueError`` where a scale's global height is not its patch
    size, as the model's forward does."""

    def stage(block, n):
        convs = conv_exchange(n, block.conv1, parts)
        return convs, pool_exchange(n, parts) if block.use_max_pool else None

    stem = conv_exchange(height, module.stem, parts)
    extractor, scales, n = [], [], stem.n_out
    for block in module.extractor:
        extractor.append(stage(block, n))
        n = _stage_out(extractor[-1]).n_out
    for ps, block in zip(module.patch_sizes, module.scales):
        scales.append(stage(block, n))
        n = _stage_out(scales[-1]).n_out
        if n != ps:
            raise ValueError(f"spatial height {n} != patch size {ps}; "
                             "use ssd_patch_sizes(input_shape)")
    return SSDPlan(stem, tuple(extractor), tuple(scales))


def spatial_plan(module, height: int, parts: int):
    """The plan of ``module``'s family (PoolResnet, Resnet, SeparableCNN,
    MobileNetV3, the SSD). Raises ``ValueError`` for another module, and
    where a layer's rows do not split over ``parts`` ranks."""
    if isinstance(module, PoolResnet):
        return poolresnet_plan(module, height, parts)
    if isinstance(module, MobileNetV3Backbone):
        return mobilenetv3_plan(module, height, parts)
    if isinstance(module, SSD):
        return ssd_plan(module, height, parts)
    raise ValueError(f"no spatial forward for {type(module).__name__}")


def _rows(ex: Exchange, index: int) -> int:
    a, b = ex.own_out[index]
    return b - a


class _Rows:
    """This rank's layers over the mesh's spatial group."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.i, self.group = mesh, mesh.spatial_index, mesh.spatial_group

    def conv(self, layer, x, ex):
        window, top, bottom = halo(x, ex, self.i, self.group)
        return conv_rows(layer, window, top, bottom, _rows(ex, self.i))

    def conv_same(self, layer, x, ex):
        window, top, bottom = halo(x, ex, self.i, self.group)
        return conv_same(layer, window, (top, bottom))

    def pool(self, x, ex):
        return max_pool_2x2(halo(x, ex, self.i, self.group)[0])

    def gather(self, y, ex):
        return gather_rows(y, ex.own_out, self.i, self.group)

    def squeeze_excite(self, se, x, ex):
        """``se`` over this rank's rows of its block's map, whose global
        height is ``ex.n_out``; the module's own call at one rank."""
        if self.mesh.spatial == 1:
            return se(x)
        s = sum_over(x.float().sum((2, 3), keepdim=True), self.group, "se")
        s = (s / (ex.n_out * x.shape[3])).to(x.dtype)
        s = conv(se.expand, F.relu(conv(se.reduce, s)))
        return x * hard_sigmoid(s)


def _grid_forward(module: PoolResnet, x, plan: PoolResnetPlan, on: _Rows, masks):
    x = on.conv(module.conv1, x, plan.stem)
    for block, (convs, pool) in zip(module.residual_blocks, plan.blocks):
        skip = x
        if isinstance(block, SeparableResidualBlock):
            x = leaky_relu(conv(block.pointwise_conv1, x))
            x = leaky_relu(on.conv(block.depthwise_conv, x, convs))
            x = block.dropout(conv(block.pointwise_conv2, x), masks) + skip
        else:
            x = leaky_relu(on.conv(block.conv1, x, convs))
            x = on.conv(block.conv2, x, convs)
            x = block.dropout(leaky_relu(x), masks) + skip
        if pool is not None:
            x = on.pool(x, pool)
    x = on.conv(module.out, module.head_dropout(x, masks), plan.head)
    return on.gather(torch.sigmoid(x.float()), plan.head).permute(0, 2, 3, 1).contiguous()


def _mobilenetv3_forward(module: MobileNetV3Backbone, x, plan: MobileNetV3Plan, on: _Rows,
                         train: bool, update_stats: bool):
    with batch_norm_over(module, on.mesh.group if train else None):
        x = hard_swish(module.bn1(on.conv_same(module.conv_stem, x, plan.stem), train,
                                  update_stats))
        for block, ex in zip(module.blocks, plan.blocks):
            y = x
            if block.conv_pw is not None:
                y = block.act(block.bn1(conv(block.conv_pw, y), train, update_stats))
            y = block.act(block.bn2(on.conv_same(block.conv_dw, y, ex), train, update_stats))
            if block.se is not None:
                y = on.squeeze_excite(block.se, y, ex)
            y = block.bn3(conv(block.conv_pwl, y), train, update_stats)
            x = y + x if block.residual else y
        x = hard_swish(module.bn_576(conv(module.conv_576, x), train, update_stats))
    x = on.conv(module.head, x, plan.head)
    return on.gather(torch.sigmoid(x.float()), plan.head).permute(0, 2, 3, 1).contiguous()


def _ssd_block(block, x, stage: Stage, on: _Rows, masks):
    convs, pool = stage
    skip = x if block.skip is None else conv(block.skip, x)
    x = leaky_relu(on.conv(block.conv1, x, convs))
    x = block.dropout(leaky_relu(on.conv(block.conv2, x, convs)), masks) + skip
    return x if pool is None else on.pool(x, pool)


def _ssd_forward(module: SSD, x, plan: SSDPlan, on: _Rows, masks):
    x = on.conv(module.stem, x, plan.stem)
    for block, stage in zip(module.extractor, plan.extractor):
        x = _ssd_block(block, x, stage, on, masks)
    b, outs = x.shape[0], []
    for ps, block, head, stage in zip(module.patch_sizes, module.scales, module.heads,
                                      plan.scales):
        x = _ssd_block(block, x, stage, on, masks)
        if x.shape[3] != ps:
            raise ValueError(f"spatial width {x.shape[3]} != patch size {ps}; "
                             "use ssd_patch_sizes(input_shape)")
        # the position-wise head on this rank's rows, then the scale's rows gathered
        z = F.linear(x.permute(0, 2, 3, 1), head.weight.to(x.dtype), head.bias.to(x.dtype))
        z = on.gather(z.float().permute(0, 3, 1, 2), _stage_out(stage)).permute(0, 2, 3, 1)
        outs.append(z.reshape(b, ps * ps, 5))
    out = torch.cat(outs, dim=1)
    out = torch.cat([torch.sigmoid(out[..., :1]), out[..., 1:]], dim=-1)
    priors, scales = priors_on(module.patch_sizes, out.device)
    return apply_priors(out, priors, scales)


def spatial_forward(module, rows: torch.Tensor, plan, mesh: Mesh,
                    masks: DropoutMasks | None = None, train: bool = False,
                    update_stats: bool = True) -> torch.Tensor:
    """``module``'s forward from this rank's rows of the images, ``(B, h,
    W, 3)`` (the rows ``plan.image_rows[mesh.spatial_index]``), over the
    mesh: the model's whole output on every rank of the spatial group (the
    ``(B, S, S, 5)`` grid, or the SSD's ``(B, N, 5)`` boxes). Dropout
    applies when given ``masks``; MobileNetV3 takes ``train`` and
    ``update_stats`` as its forward does, and in ``train`` mode normalises
    by the statistics of the whole mesh's batch."""
    on = _Rows(mesh)
    x = rows.permute(0, 3, 1, 2)
    if isinstance(plan, MobileNetV3Plan):
        x = x.to(module.compute_dtype or module.conv_stem.weight.dtype)
        return _mobilenetv3_forward(module, x, plan, on, train, update_stats)
    if isinstance(plan, SSDPlan):
        return _ssd_forward(module, x.to(module.compute_dtype or module.stem.weight.dtype), plan,
                            on, masks)
    x = x.to(module.compute_dtype or module.conv1.weight.dtype)
    return _grid_forward(module, x, plan, on, masks)
