"""The residual-tail shootout on one CUDA card: the counterpart of
``scripts/bench_pool_fusion.py``.

    python -m fdtpu_torch.bench_pool_fusion [--batch 128] [--size 320] [--grid 15]
                                            [--iters 50]

The eval forward of PoolResnet-128 (10 blocks, grid 15 at 320 px by
default) in bfloat16 and channels_last, as the ``Detector`` serves it, with
random weights and frames from seed 0, in three arms that differ only in
each residual block's tail ``leaky(c2) + skip [-> maxpool2x2]``:

* ``prod``: the eager tail (fdtpu's production block: conv2's bias add,
  leaky ReLU, add, max-pool, each its own kernel);
* ``slicemax``: the tail as the max of four strided slices of
  ``leaky(c2) + skip``;
* ``fused``: the fused residual-tail kernel (``kernels/epilogue.py``) in
  every block, conv2's bias folded in, ``PoolResnet(fused_tail=True)``:
  one launch a block.

Every arm is first held bit-equal to ``prod`` on the batch; then each
forward is timed with CUDA events after warmup, in the order prod,
slicemax, fused, fused, slicemax, prod, and the two runs of each arm are
averaged. Prints one JSON line with the card's nvidia-smi name and power
limit. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import Detector, build_model
from fdtpu_torch.models.layers import conv, leaky_relu, narrow_conv
from fdtpu_torch.utils.config import DetectorConfig

ARMS = ("prod", "slicemax", "fused")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def serving_net(size: int, grid: int, seed: int = 0):
    """The ``Detector``'s bfloat16 channels_last eval copy of a PoolResnet-128
    with 10 blocks, weights drawn from ``seed``, on the card."""
    cfg = DetectorConfig(input_shape=(size, size), num_patches=grid)
    module = build_model("poolresnet", cfg, "cuda", torch.Generator().manual_seed(seed))
    return Detector(module).net


def frames(batch: int, size: int, seed: int = 0) -> torch.Tensor:
    """Random u8 frames on the card, scaled to [0, 1] as the serving path does."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u8 = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    return u8.float() / 255.0


def set_fused_tail(net, on: bool) -> None:
    for block in net.residual_blocks:
        block.fused_tail = on


def slicemax_tail(c2: torch.Tensor, skip: torch.Tensor, pool: bool) -> torch.Tensor:
    y = leaky_relu(c2) + skip
    if not pool:
        return y
    return torch.maximum(torch.maximum(y[:, :, 0::2, 0::2], y[:, :, 0::2, 1::2]),
                         torch.maximum(y[:, :, 1::2, 0::2], y[:, :, 1::2, 1::2]))


def slicemax_forward(net, images: torch.Tensor) -> torch.Tensor:
    """``net``'s eval forward with the slicemax tail in every block (the
    stem and head as the forward runs them, ``layers.narrow_conv``)."""
    x = images.permute(0, 3, 1, 2).to(net.conv1.weight.dtype)
    x = narrow_conv(net.conv1, x)
    for block in net.residual_blocks:
        c2 = conv(block.conv2, leaky_relu(conv(block.conv1, x)))
        x = slicemax_tail(c2, x, c2.shape[2] > block.pool_until)
    x = narrow_conv(net.out, x)
    return torch.sigmoid(x.float()).permute(0, 2, 3, 1).contiguous()


@torch.inference_mode()
def run_arm(net, images: torch.Tensor, arm: str) -> torch.Tensor:
    if arm == "slicemax":
        return slicemax_forward(net, images)
    set_fused_tail(net, arm == "fused")
    try:
        return net(images)
    finally:
        set_fused_tail(net, False)


def event_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(batch: int, size: int, grid: int, iters: int) -> dict:
    """Gate every arm bit-equal to ``prod``, then time each; returns the
    result line's fields."""
    net = serving_net(size, grid)
    images = frames(batch, size)
    outs = {arm: run_arm(net, images, arm) for arm in ARMS}
    torch.cuda.synchronize()
    for arm in ARMS:
        if not torch.equal(outs[arm], outs["prod"]):
            err = (outs[arm] - outs["prod"]).abs().max().item()
            raise RuntimeError(f"arm {arm} differs from prod by up to {err} at b{batch} {size}px")
    start = LAUNCHES["residual_tail"]
    run_arm(net, images, "fused")
    launches = LAUNCHES["residual_tail"] - start
    if launches != len(net.residual_blocks):
        raise RuntimeError(f"the fused forward launched the tail kernel {launches} times")
    order = ("prod", "slicemax", "fused", "fused", "slicemax", "prod")
    runs = {arm: [] for arm in ARMS}
    for arm in order:
        runs[arm].append(event_ms(lambda a=arm: run_arm(net, images, a), iters))
    result = {"batch": batch, "size": size, "grid": grid, "iters": iters,
              "bit_equal_to_prod": True, "tail_launches_per_forward": launches}
    for arm in ARMS:
        result[f"fwd_{arm}_ms"] = sum(runs[arm]) / 2
        result[f"fwd_{arm}_runs_ms"] = runs[arm]
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--grid", type=int, default=15)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_pool_fusion needs a CUDA card")
    result = measure(args.batch, args.size, args.grid, args.iters)
    result["device"] = torch.cuda.get_device_name(0)
    result["card"] = card_line()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
