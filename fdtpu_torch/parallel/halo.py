"""The row-halo exchange of the spatial axis, with its backward.

fdtpu shards the image height over its ``spatial`` mesh axis and lets XLA
insert the convolutions' halo exchanges. Here they are written out, since
torch's own halo convolution (``torch.distributed.tensor``'s ``_tp_conv``)
shards only the last dimension and refuses a stride above 1 with padding,
which PoolResnet's stem (k 10, stride 8, pad 2) has.

**Ownership.** The rows of each layer's *global* output are split over the
ranks of a spatial group ceil-first (``mesh.row_split``). A rank computes the
output rows it owns, and holds them as the next layer's input. The window of
those rows (a convolution's ``[o·s − p, o·s − p + k)``, the 2x2 pool's
``[2o, 2o + 2)``) names the global input rows it reads: the rows it owns,
rows that other ranks own (one or several; a window can reach past the next
rank), and rows outside the image, which are the zero padding. An
:class:`Exchange` holds these tables for one layer, for every rank.

**The exchange** (:func:`halo`) returns the rank's window without its zero
rows, and their count above and below, which the layer turns back into
padding (:func:`conv_rows`). Only the rows some rank reads and does not own
travel: each has a slot in one zeroed buffer, its owner writes it there, and
one ``all_reduce`` (a sum) over the spatial group gives every rank every
slot. That is an exact copy, since ``x + 0 = x``, and ``all_reduce`` is a
collective that both NCCL and gloo take on CUDA tensors. The backward
returns each fetched row's gradient to its owner the same way: readers write
their gradients into the slots, the ``all_reduce`` sums them, and each owner
adds its slots into its own rows' gradient. Every rank of the group calls
both collectives, whether it fetches anything or not.

:func:`gather_rows` gathers the rows of the last layer's output into the
whole map on every rank of the group (the same zeroed-buffer ``all_reduce``);
its backward hands each rank the gradient of its own rows.

A layer padded ``"SAME"`` (MobileNetV3's strided layers pad one row more
below than above) takes its pads from the *global* height
(:func:`same_exchange`), since a shard's height would give other pads.

:func:`sum_over` is the other collective of the spatial step: a sum over a
group (a BatchNorm's per-channel sums over the mesh, a squeeze-excite's
per-sample sums over a spatial group), whose backward sums the gradient, as
every rank's loss reads the total.

Every rank of a group must run the same exchanges in the same order, as
every rank of a spatial step does. ``timer``, when a dict, collects the
host seconds of the collectives (the device synchronised before and after
each): the row exchanges under ``forward`` and ``backward``, a
:func:`sum_over` under its own ``kind``: the measurement of
``chip_smoke.py`` phase 19. While a profiler is active each collective is a
span (``utils/trace.py``), in ``Trainer.profile``'s trace: ``spatial/halo``,
``spatial/gather``, ``spatial/<kind>``, ``spatial/halo_backward`` and
``spatial/<kind>_backward``.

**Under a CUDA graph** (``train/graphs.py``). The tables are host
constants of the plan, so every buffer's shape follows from the layer's
geometry alone, never from the data, and nothing here waits for the card
unless ``timer`` is set, which a capture refuses. Over NCCL each
``all_reduce`` is a kernel the capture records, and a replay runs the same
exchanges with the rows then in the buffers. No collective has an empty
buffer: where no rank reads another's rows (every layer of a 1 x 1 mesh, and
a 1 x 2 mesh's 1x1 convolutions) :func:`halo` runs none and returns a view,
and :func:`gather_rows` over one rank returns its input. So on a 1 x 1 mesh
a replay runs the model's own layers and no row collective; the step's
collectives there are the gradient and loss reductions over the mesh.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fdtpu_torch.models.layers import conv, same_pads
from fdtpu_torch.parallel.mesh import row_split
from fdtpu_torch.utils import trace

timer: dict | None = None


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One layer's rows over a spatial group of ``len(own_in)`` ranks:
    ``n_in`` input rows, owned as ``own_in``; ``n_out`` output rows, owned
    as ``own_out``; ``need[i]``, the global input rows ``[lo, hi)`` rank
    ``i``'s window reads (below 0 or from ``n_in`` on: zero padding);
    ``slots``, the rows some rank reads and does not own, sorted."""

    n_in: int
    n_out: int
    own_in: tuple[tuple[int, int], ...]
    own_out: tuple[tuple[int, int], ...]
    need: tuple[tuple[int, int], ...]
    slots: tuple[int, ...]

    def clipped(self, i: int) -> tuple[int, int]:
        """Rank ``i``'s window inside the image."""
        lo, hi = self.need[i]
        return max(lo, 0), min(hi, self.n_in)

    def pads(self, i: int) -> tuple[int, int]:
        """The zero rows above and below rank ``i``'s window."""
        lo, hi = self.need[i]
        return max(-lo, 0), max(hi - self.n_in, 0)

    def runs(self, i: int):
        """Rank ``i``'s window as ``(before, mine, after)``: the slot range
        ``(first slot, count)`` of the rows above its own, the local range
        ``(first row, count)`` of its own rows in the window, and the slot
        range of the rows below them."""
        (c0, c1), (a, b) = self.clipped(i), self.own_in[i]
        n_before = max(min(c1, a) - c0, 0)
        m0, m1 = max(c0, a), min(c1, b)
        n_after = max(c1 - max(c0, b), 0)
        before = (bisect.bisect_left(self.slots, c0), n_before)
        after = (bisect.bisect_left(self.slots, max(c0, b)), n_after)
        return before, (m0 - a, max(m1 - m0, 0)), after

    def writes(self, i: int) -> list[tuple[int, int, int]]:
        """The slots rank ``i`` owns, as runs ``(first slot, first local
        row, count)`` of consecutive rows."""
        a, b = self.own_in[i]
        runs: list[list[int]] = []
        for s in range(bisect.bisect_left(self.slots, a), bisect.bisect_left(self.slots, b)):
            r = self.slots[s] - a
            if runs and runs[-1][0] + runs[-1][2] == s and runs[-1][1] + runs[-1][2] == r:
                runs[-1][2] += 1
            else:
                runs.append([s, r, 1])
        return [tuple(run) for run in runs]


def window_exchange(n_in: int, k: int, s: int, p: int | tuple[int, int],
                    parts: int) -> Exchange:
    """The exchange of a ``k``-tap, stride-``s`` window padded by ``p`` in
    the height (``(top, bottom)`` when they differ), over ``n_in`` rows
    split ceil-first over ``parts`` ranks. Raises ``ValueError`` if a rank
    would own no row."""
    top, bottom = (p, p) if isinstance(p, int) else p
    n_out = (n_in + top + bottom - k) // s + 1
    if n_out < parts or n_in < parts:
        raise ValueError(f"{n_in} rows in, {n_out} out do not split over {parts} spatial ranks")
    own_in = tuple(row_split(n_in, parts))
    own_out = tuple(row_split(n_out, parts))
    need = tuple((o0 * s - top, (o1 - 1) * s - top + k) for o0, o1 in own_out)
    slots = set()
    for (lo, hi), (a, b) in zip(need, own_in):
        slots.update(r for r in range(max(lo, 0), min(hi, n_in)) if not a <= r < b)
    return Exchange(n_in, n_out, own_in, own_out, need, tuple(sorted(slots)))


def conv_exchange(n_in: int, layer: torch.nn.Conv2d, parts: int) -> Exchange:
    """The exchange of ``layer``'s window in the height."""
    return window_exchange(n_in, layer.kernel_size[0], layer.stride[0], layer.padding[0], parts)


def same_exchange(n_in: int, layer: torch.nn.Conv2d, parts: int) -> Exchange:
    """The exchange of ``layer`` padded ``"SAME"`` on the global height
    ``n_in`` (``layers.same_pads``: ``ceil(n_in / s)`` rows out)."""
    k, s = layer.kernel_size[0], layer.stride[0]
    return window_exchange(n_in, k, s, same_pads(n_in, k, s), parts)


def pool_exchange(n_in: int, parts: int) -> Exchange:
    """The exchange of the 2x2/2 max pool (floor: an odd last row is
    dropped)."""
    return window_exchange(n_in, 2, 2, 0, parts)


@contextlib.contextmanager
def _timed(kind: str, device: torch.device):
    if timer is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timer[kind] = timer.get(kind, 0.0) + time.perf_counter() - t0


def _rows_like(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Contiguous zeros of ``x``'s shape with ``rows`` rows. An all-reduce
    sums memory, not indices, and the ranks' activations can differ in
    layout (a convolution's output format follows its shape, and the
    ranks' shapes differ), so every rank's buffer has the one layout."""
    return x.new_zeros((x.shape[0], x.shape[1], rows, x.shape[3]))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex: Exchange, index: int, group):
        ctx.ex, ctx.index, ctx.group = ex, index, group
        ctx.shape = x.shape
        (sb, nb), (m0, nm), (sa, na) = ex.runs(index)
        with trace.span("spatial/halo"), _timed("forward", x.device):
            buf = _rows_like(x, len(ex.slots))
            for s0, r0, n in ex.writes(index):
                buf[:, :, s0:s0 + n] = x[:, :, r0:r0 + n]
            dist.all_reduce(buf, group=group)
            parts = [buf[:, :, sb:sb + nb], x[:, :, m0:m0 + nm], buf[:, :, sa:sa + na]]
            return torch.cat([t for t in parts if t.shape[2]], dim=2)

    @staticmethod
    def backward(ctx, g):
        ex, index = ctx.ex, ctx.index
        (sb, nb), (m0, nm), (sa, na) = ex.runs(index)
        with trace.span("spatial/halo_backward"), _timed("backward", g.device):
            grad = _rows_like(g, ctx.shape[2])
            buf = _rows_like(g, len(ex.slots))
            buf[:, :, sb:sb + nb] = g[:, :, :nb]
            grad[:, :, m0:m0 + nm] = g[:, :, nb:nb + nm]
            buf[:, :, sa:sa + na] = g[:, :, nb + nm:]
            dist.all_reduce(buf, group=ctx.group)
            for s0, r0, n in ex.writes(index):
                grad[:, :, r0:r0 + n] += buf[:, :, s0:s0 + n]
        return grad, None, None, None


def halo(x: torch.Tensor, ex: Exchange, index: int, group) -> tuple[torch.Tensor, int, int]:
    """Rank ``index``'s window of ``ex`` from its own rows ``x`` (NCHW,
    the rows ``ex.own_in[index]``): ``(rows, top, bottom)``, the window's
    rows inside the image and the zero rows it has above and below. Where
    no rank of the group reads another's rows, no collective runs and the
    window is a view of ``x`` (``x`` itself when it is all of it)."""
    if ex.slots:
        return _Halo.apply(x, ex, index, group), *ex.pads(index)
    (c0, c1), (a, b) = ex.clipped(index), ex.own_in[index]
    rows = x if (c0, c1) == (a, b) else x[:, :, c0 - a:c1 - a]
    return rows, *ex.pads(index)


def conv_rows(layer: torch.nn.Conv2d, x: torch.Tensor, top: int, bottom: int,
              rows: int) -> torch.Tensor:
    """``layer`` over a window from :func:`halo`: ``rows`` output rows, the
    height padded by ``top`` and ``bottom`` zero rows, the width by the
    layer's own padding. Equal pads go to the convolution, as the layer
    itself pads; unequal ones too when the extra rows cost whole strides
    (the outputs they add are sliced off), else the rows are padded first."""
    s, pw = layer.stride[0], layer.padding[1]
    pad = max(top, bottom)
    if (pad - top) % s:
        return conv(layer, F.pad(x, (0, 0, top, bottom)), padding=(0, pw))
    y = conv(layer, x, padding=(pad, pw))
    skip = (pad - top) // s
    if skip == 0 and y.shape[2] == rows:
        return y
    return y[:, :, skip:skip + rows]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, own: tuple[tuple[int, int], ...], index: int, group):
        ctx.rows = own[index]
        a, b = ctx.rows
        with trace.span("spatial/gather"), _timed("forward", y.device):
            buf = _rows_like(y, own[-1][1])
            buf[:, :, a:b] = y
            dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[:, :, a:b], None, None, None


def gather_rows(y: torch.Tensor, own: tuple[tuple[int, int], ...], index: int,
                group) -> torch.Tensor:
    """The whole NCHW map on every rank of the group, from each rank's
    rows ``own[i]`` of it; the backward gives each rank its own rows'
    gradient. With one rank, ``y`` itself."""
    if len(own) == 1:
        return y
    return _Gather.apply(y, tuple(own), index, group)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind: str):
        ctx.group, ctx.kind = group, kind
        with trace.span(f"spatial/{kind}"), _timed(f"{kind} forward", x.device):
            total = x.contiguous().clone()
            dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        with trace.span(f"spatial/{ctx.kind}_backward"), \
                _timed(f"{ctx.kind} backward", g.device):
            total = g.contiguous().clone()
            dist.all_reduce(total, group=ctx.group)
        return total, None, None


def sum_over(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (one ``all_reduce``),
    on every rank. Its backward sums the gradient over the group too: every
    rank's loss reads the total, so each rank's share of it is the sum of
    all the ranks' gradients. ``kind`` names it in ``timer`` and in the
    profiler's spans."""
    return _Sum.apply(x, group, kind)
