"""L1 structured pruning (``compat/pruning.py``) against fdtpu's
``prune_l1_structured``: from the same weights the port keeps the same
channels, so its pruned weights equal fdtpu's pruned params after
conversion exactly, and the pruned forwards agree within float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.compat import prune_l1_structured as jax_prune
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.models import Resnet as JaxResnet
from fdtpu_torch.compat import poolresnet_state_dict, resnet_state_dict
from fdtpu_torch.compat.pruning import kept_filters, prune_l1_structured
from fdtpu_torch.models import PoolResnet, Resnet, SeparableCNN

FORWARD_ATOL = 2e-5  # float32 forwards, port against fdtpu (test_torch_models.py's bar)


def pair(kind, filters, seed=0, tie=False):
    if kind == "poolresnet":
        jm = JaxPoolResnet(filters=filters, input_shape=(160, 160), num_patches=10,
                           num_residual_blocks=2, dtype=jnp.float32)
        tm, convert = PoolResnet(filters, (160, 160), 10, 2), poolresnet_state_dict
    else:
        jm = JaxResnet(filters=filters, input_shape=(96, 96), num_patches=6,
                       num_residual_blocks=2, dtype=jnp.float32)
        tm, convert = Resnet(filters, (96, 96), 6, 2), resnet_state_dict
    size = jm.input_shape[0]
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    if tie:  # equal L1 scores: the lower index must win, as in fdtpu's stable sort
        stem = params["Conv_0"]["kernel"].copy()
        stem[..., 1::2] = stem[..., 0:-1:2]
        params["Conv_0"]["kernel"] = stem
    # non-zero biases, so that their slicing shows
    for name, p in params.items():
        for conv in (p.values() if name.startswith("ResidualBlock") else [p]):
            conv["bias"] = np.random.default_rng(seed).normal(
                size=conv["bias"].shape).astype(np.float32)
    tm.load_state_dict(convert(params))
    return jm, {"params": params}, tm.eval(), convert


@pytest.mark.parametrize("kind,filters,amount,align,tie", [
    ("poolresnet", 20, 0.2, None, False),
    ("poolresnet", 32, 0.2, 16, False),
    ("poolresnet", 20, 0.5, None, True),
    ("resnet", 24, 0.2, None, False),
    ("resnet", 24, 0.3, 8, False),
])
def test_pruned_weights_equal_fdtpu(kind, filters, amount, align, tie):
    jm, variables, tm, convert = pair(kind, filters, tie=tie)
    pm, pv = jax_prune(jm, variables, amount, align=align)
    pruned = prune_l1_structured(tm, amount, align=align)
    assert type(pruned) is type(tm) and pruned.conv1.out_channels == pm.filters
    want = convert(jax.tree.map(np.asarray, pv["params"]))
    got = pruned.state_dict()
    assert set(got) == set(want)
    for name, tensor in want.items():
        assert torch.equal(got[name], tensor), name
    x = np.random.default_rng(1).uniform(0, 1, (2, *jm.input_shape, 3)).astype(np.float32)
    with torch.no_grad():
        out = pruned(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(pm.apply(pv, jnp.asarray(x), train=False)),
                               atol=FORWARD_ATOL, rtol=0)
    assert pruned.grid_size() == tm.grid_size()


@pytest.mark.parametrize("filters,amount,align", [(128, 0.2, None), (128, 0.2, 64),
                                                  (128, 0.2, 128), (100, 0.25, 32),
                                                  (20, 0.2, None), (30, 0.9, 16)])
def test_align_rounds_down(filters, amount, align):
    """``align`` rounds the kept count down to a multiple, never below
    ``align``: 128 -> 102, or 64 with align 64; fdtpu counts the same."""
    keep = kept_filters(filters, amount, align)
    exact = filters - int(round(filters * amount))
    if align:
        assert keep % align == 0 and keep <= max(exact, align)
        assert keep == max(align, exact // align * align)
    else:
        assert keep == exact
    jm = JaxPoolResnet(filters=filters, input_shape=(64, 64), num_patches=2,
                       num_residual_blocks=1, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    assert jax_prune(jm, v, amount, align=align)[0].filters == keep
    assert kept_filters(128, 0.2) == 102 and kept_filters(128, 0.2, 64) == 64


def test_pruning_keeps_the_device_dtype_and_options():
    tm = PoolResnet(16, (160, 160), 10, 2, fused_tail=True, compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0)).to(torch.float64)
    pruned = prune_l1_structured(tm, 0.25)
    assert pruned.conv1.weight.dtype == torch.float64 and pruned.conv1.out_channels == 12
    assert pruned.compute_dtype == torch.bfloat16
    assert all(b.fused_tail for b in pruned.residual_blocks)


def test_pruning_refuses_other_families():
    with pytest.raises(ValueError):
        prune_l1_structured(SeparableCNN(16, (128, 128), 8, 2), 0.2)


def test_pruner_entry_point(tmp_path):
    """``python -m fdtpu_torch.pruner`` on the CPU: it times the forward
    before and after, and its saved checkpoint serves at the kept width."""
    from fdtpu_torch import pruner
    from fdtpu_torch.demo_model import load_weights
    from fdtpu_torch.models import build_model
    from fdtpu_torch.utils.config import DetectorConfig

    save = tmp_path / "pruned.pt"
    module, pruned = pruner.main(["--input", "160", "--patches", "5", "--filters", "20",
                                  "--blocks", "2", "--batch", "2", "--save", str(save),
                                  "--device", "cpu"])
    assert pruned.conv1.out_channels == 16
    cfg = DetectorConfig(filters=16, input_shape=(160, 160), num_patches=5,
                         num_residual_blocks=2)
    served = load_weights(build_model("poolresnet", cfg, "cpu"), str(save), "cpu")
    for name, tensor in pruned.state_dict().items():
        assert torch.equal(served.state_dict()[name], tensor)
