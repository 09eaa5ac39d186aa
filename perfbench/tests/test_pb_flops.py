"""The analytic FLOP counts equal ``FlopCounterMode``'s count of the
plain references' convolutions and linear layers, forward and a SAM
step's backward, at a small size on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import reference, weights
from perfbench.roofline import flops

MODELS = {
    "poolresnet": dict(filters=8, input_shape=[96, 96], num_patches=3, num_residual_blocks=4,
                       input_kernel_size=10, input_stride=8, output_kernel_size=4,
                       output_padding=0, dropout=0.25, head_dropout=0.5),
    "ssd": dict(filters=4, input_shape=[96, 96], patch_sizes=[12, 6, 3, 1], dropout=0.25),
}


def counted(family, model, backward):
    ref = reference.family(family)
    params = weights.draw(ref.param_specs(model), 3, "cpu")
    for p in params.values():
        p.requires_grad_(backward)
    x = torch.rand(2, *model["input_shape"], 3)
    counter = FlopCounterMode(display=False)
    with counter:
        out = ref.forward(params, x, model)
        if backward:
            torch.autograd.grad(out.sum(), list(params.values()))
    return counter.get_total_flops() / 2


@pytest.mark.parametrize("family", list(MODELS))
def test_forward(family):
    assert counted(family, MODELS[family], False) == pytest.approx(
        flops.forward_flops(family, MODELS[family]), rel=1e-12)


@pytest.mark.parametrize("family", list(MODELS))
def test_train_step(family):
    """One forward and backward is half a SAM step."""
    assert 2 * counted(family, MODELS[family], True) == pytest.approx(
        flops.train_step_flops(family, MODELS[family]), rel=1e-12)


def test_config_of_record():
    """PoolResnet-128 at 480 px, grid 10: about 4.0 GFLOP a forward (the
    stem 0.28, the blocks at 60, 30 and 15 px 2.12, 0.53 and 1.06)."""
    import json
    from pathlib import Path

    conf = json.loads((Path(__file__).resolve().parents[1] / "configs"
                       / "poolresnet128-g10-480.json").read_text())
    fwd, stem = flops.poolresnet(conf["model"])
    assert stem == pytest.approx(0.27648e9, rel=1e-5)
    assert fwd == pytest.approx(3.99698e9, rel=1e-5)
