"""The port's import of the reference's TorchScript checkpoints
(``fdtpu_torch/compat/torch_import.py``) against fdtpu's
(``fdtpu/compat/torch_import.py``).

No official checkpoint is needed: a random state_dict under the reference's
names (a grid model's, and MobileNetV3's in timm's stage layout, BatchNorm
``num_batches_tracked`` included) is saved as a TorchScript archive by
scripting a module that registers those names. The same archive goes
through fdtpu's ``load_torchscript_weights`` and through the port's; the
two forwards must agree at float32 atol 1e-5 (summation order only), and
``ReferenceLayoutGrid`` must swap the output's spatial axes as fdtpu's
does. The parity tests on the official checkpoints skip while those files
are absent (``tests/test_compat.py``'s ``OFFICIAL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.compat import load_torchscript_weights as jax_load_torchscript_weights
from fdtpu.compat.torch_import import ReferenceLayoutGrid as JaxReferenceLayoutGrid
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.models import Resnet as JaxResnet
from fdtpu.models import SeparableCNN as JaxSeparableCNN
from fdtpu.models.mobilenetv3 import MOBILENETV3_SMALL as JAX_MOBILENETV3_SMALL
from fdtpu.models.mobilenetv3 import make_divisible as jax_make_divisible
from fdtpu_torch.compat import (
    ReferenceLayoutGrid,
    load_reference_detector,
    load_torchscript_weights,
    pretrained_backbone_variables,
    read_torchscript_state_dict,
)
from fdtpu_torch.models import MobileNetV3Backbone, PoolResnet, Resnet, SeparableCNN
from test_compat import OFFICIAL

SIZE = (160, 160)
ATOL = 1e-5


class Holder(torch.nn.Module):
    """A scriptable module that only carries named tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def save_archive(tensors: dict, path) -> None:
    """Save ``{dotted name: tensor}`` as a TorchScript archive whose
    ``state_dict`` has exactly those names (BatchNorm statistics and
    ``num_batches_tracked`` as buffers, the rest as params)."""
    root = Holder()
    for name, tensor in tensors.items():
        *path_, leaf = name.split(".")
        mod = root
        for part in path_:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        if leaf in ("running_mean", "running_var", "num_batches_tracked"):
            mod.register_buffer(leaf, tensor)
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(tensor, requires_grad=False))
    torch.jit.script(root).save(str(path))


def random_like(shape, rng, scale=None):
    """Normal values, a conv kernel's with variance 1 / fan_in (activations
    of order 1 through the 40-odd layers of MobileNetV3), a vector's with
    std 0.1."""
    if scale is None:
        scale = 1 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.1
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))


def reference_grid_state_dict(module: torch.nn.Module, seed=0) -> dict:
    """A grid model's reference state_dict: the reference's names are the
    port's (``conv1``, ``residual_blocks.*``, ``out``), random values."""
    rng = np.random.default_rng(seed)
    return {k: random_like(v.shape, rng) for k, v in module.state_dict().items()}


def _bn(prefix, c, rng):
    return {f"{prefix}.weight": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            f"{prefix}.bias": random_like((c,), rng),
            f"{prefix}.running_mean": random_like((c,), rng),
            f"{prefix}.running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            f"{prefix}.num_batches_tracked": torch.tensor(1000)}


def reference_mobilenetv3_state_dict(seed=0) -> dict:
    """The reference MobileNetV3's state_dict: timm's ``feature_extractor``
    (stem ``0``, ``bn1`` ``1``, the blocks under ``3.{stage}.{j}`` in
    stages of 1, 2, 3, 2, 3 blocks and the final ConvBnAct at ``3.5.0``;
    block 0 a DepthwiseSeparableConv) and the head ``out``, built from
    fdtpu's block table, random values."""
    rng = np.random.default_rng(seed)
    sd = {"feature_extractor.0.weight": random_like((16, 3, 3, 3), rng),
          **_bn("feature_extractor.1", 16, rng)}
    stages, in_ch, flat = (1, 2, 3, 2, 3), 16, 0
    for stage, n in enumerate(stages):
        for j in range(n):
            k, exp, out, se, _, _ = JAX_MOBILENETV3_SMALL[flat]
            t = f"feature_extractor.3.{stage}.{j}"
            sd[f"{t}.conv_dw.weight"] = random_like((exp, 1, k, k), rng)
            if flat == 0:  # DepthwiseSeparableConv: conv_dw, bn1, se, conv_pw, bn2
                sd.update(_bn(f"{t}.bn1", exp, rng))
                sd[f"{t}.conv_pw.weight"] = random_like((out, exp, 1, 1), rng)
                sd.update(_bn(f"{t}.bn2", out, rng))
            else:  # InvertedResidual: conv_pw, bn1, conv_dw, bn2, se, conv_pwl, bn3
                sd[f"{t}.conv_pw.weight"] = random_like((exp, in_ch, 1, 1), rng)
                sd.update(_bn(f"{t}.bn1", exp, rng))
                sd.update(_bn(f"{t}.bn2", exp, rng))
                sd[f"{t}.conv_pwl.weight"] = random_like((out, exp, 1, 1), rng)
                sd.update(_bn(f"{t}.bn3", out, rng))
            if se:
                red = jax_make_divisible(exp * 0.25)
                sd[f"{t}.se.conv_reduce.weight"] = random_like((red, exp, 1, 1), rng)
                sd[f"{t}.se.conv_reduce.bias"] = random_like((red,), rng)
                sd[f"{t}.se.conv_expand.weight"] = random_like((exp, red, 1, 1), rng)
                sd[f"{t}.se.conv_expand.bias"] = random_like((exp,), rng)
            in_ch, flat = out, flat + 1
    sd["feature_extractor.3.5.0.conv.weight"] = random_like((576, 96, 1, 1), rng)
    sd.update(_bn("feature_extractor.3.5.0.bn1", 576, rng))
    sd["out.weight"] = random_like((5, 576, 3, 3), rng)
    sd["out.bias"] = random_like((5,), rng)
    return sd


GRID = {  # fdtpu module, the port's module, blocks; 160 px, filters 8
    "poolresnet": (lambda: JaxPoolResnet(8, SIZE, 5, 2, dtype=jnp.float32),
                   lambda: PoolResnet(8, SIZE, 5, 2)),
    "resnet": (lambda: JaxResnet(8, SIZE, 5, 2, dtype=jnp.float32), lambda: Resnet(8, SIZE, 5, 2)),
    "separable": (lambda: JaxSeparableCNN(8, SIZE, 16, 2, dtype=jnp.float32),
                  lambda: SeparableCNN(8, SIZE, 16, 2)),
}


def fdtpu_import(jm, path):
    template = jax.jit(lambda key: jm.init(key, jnp.zeros((1, *SIZE, 3))))(jax.random.PRNGKey(0))
    return jax_load_torchscript_weights(str(path), jm, template)


def images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, *SIZE, 3)).astype(np.float32)


def forward_pair(jm, variables, tm, x):
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x)))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    return got, want


@pytest.mark.parametrize("family", list(GRID))
def test_grid_import_matches_fdtpu(family, tmp_path):
    make_jax, make_torch = GRID[family]
    path = tmp_path / f"{family}.pth"
    save_archive(reference_grid_state_dict(make_torch()), path)
    jm, tm = make_jax(), make_torch()
    assert load_torchscript_weights(path, tm) is tm
    got, want = forward_pair(jm, fdtpu_import(jm, path), tm, images())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_mobilenetv3_import_matches_fdtpu(tmp_path):
    path = tmp_path / "mnv3.pth"
    sd = reference_mobilenetv3_state_dict()
    save_archive(sd, path)
    assert len(sd) == 242  # as the official archive: one num_batches_tracked a BatchNorm among them
    jm, tm = JaxMobileNetV3(SIZE, 5, dtype=jnp.float32), MobileNetV3Backbone(SIZE, 5)
    load_torchscript_weights(path, tm)
    # the DepthwiseSeparableConv's bn1 / conv_pw / bn2 are block 0's bn2 / conv_pwl / bn3
    assert torch.equal(tm.blocks[0].bn2.running_var, sd["feature_extractor.3.0.0.bn1.running_var"])
    assert torch.equal(tm.blocks[0].conv_pwl.weight, sd["feature_extractor.3.0.0.conv_pw.weight"])
    assert torch.equal(tm.blocks[4].bn3.weight, sd["feature_extractor.3.2.1.bn3.weight"])
    assert torch.equal(tm.bn_576.running_mean, sd["feature_extractor.3.5.0.bn1.running_mean"])
    got, want = forward_pair(jm, fdtpu_import(jm, path), tm, images(seed=1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["poolresnet", "mobilenetv3"])
def test_reference_layout_grid_swaps_as_fdtpu(family, tmp_path):
    """``load_reference_detector`` wraps a grid model: its output is the
    inner model's with the spatial axes swapped, equal to fdtpu's wrapped
    model's; ``input_shape``, ``grid_size`` and ``compute_dtype`` are the
    inner model's."""
    path = tmp_path / "ref.pth"
    if family == "mobilenetv3":
        jm, tm = JaxMobileNetV3(SIZE, 5, dtype=jnp.float32), MobileNetV3Backbone(SIZE, 5)
        save_archive(reference_mobilenetv3_state_dict(seed=1), path)
    else:
        make_jax, make_torch = GRID[family]
        jm, tm = make_jax(), make_torch()
        save_archive(reference_grid_state_dict(tm, seed=1), path)
    wrapped = load_reference_detector(path, tm)
    assert isinstance(wrapped, ReferenceLayoutGrid) and wrapped.inner is tm
    assert wrapped.input_shape == SIZE and wrapped.grid_size() == tm.grid_size() == 5
    wrapped.compute_dtype = torch.bfloat16
    assert tm.compute_dtype is torch.bfloat16
    wrapped.compute_dtype = None
    x = images(seed=2)
    jw = JaxReferenceLayoutGrid(jm)
    jvars = {k: {"inner": v} for k, v in fdtpu_import(jm, path).items()}
    got, want = forward_pair(jw, jvars, wrapped, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    inner = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, inner.swapaxes(1, 2))


def test_import_checks_names_and_shapes(tmp_path):
    good = reference_grid_state_dict(PoolResnet(8, SIZE, 5, 2))
    bad_shape = dict(good, **{"out.weight": torch.zeros(5, 8, 3, 3)})
    missing = {k: v for k, v in good.items() if k != "out.bias"}
    for name, sd, match in (("shape", bad_shape, "out.weight"), ("missing", missing, "out.bias")):
        save_archive(sd, tmp_path / f"{name}.pth")
        tm = PoolResnet(8, SIZE, 5, 2)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        with pytest.raises(ValueError, match=match):
            load_torchscript_weights(tmp_path / f"{name}.pth", tm)
        assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())  # untouched
    save_archive(reference_mobilenetv3_state_dict(), tmp_path / "mnv3.pth")
    with pytest.raises(ValueError):  # a MobileNetV3 archive into a grid model
        load_torchscript_weights(tmp_path / "mnv3.pth", PoolResnet(8, SIZE, 5, 2))


def test_read_torchscript_state_dict_with_stub_ops(tmp_path):
    """The stubs of torchvision's ops register once a process, so reading
    twice works; the tensors come back as saved."""
    sd = reference_grid_state_dict(SeparableCNN(8, SIZE, 16, 2))
    save_archive(sd, tmp_path / "sep.pth")
    for _ in range(2):
        got = read_torchscript_state_dict(tmp_path / "sep.pth")
        assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    assert torch.ops.torchvision.nms is not None


def test_pretrained_backbone_keeps_a_fresh_head(tmp_path):
    path = tmp_path / "mnv3.pth"
    sd = reference_mobilenetv3_state_dict(seed=3)
    save_archive(sd, path)
    tm = MobileNetV3Backbone(SIZE, 5, generator=torch.Generator().manual_seed(0))
    head = {k: v.clone() for k, v in tm.state_dict().items() if k.startswith("head.")}
    tm.load_state_dict(pretrained_backbone_variables(path, tm))
    assert all(torch.equal(tm.state_dict()[k], v) for k, v in head.items())
    assert torch.equal(tm.conv_stem.weight, sd["feature_extractor.0.weight"])
    assert torch.equal(tm.bn1.running_var, sd["feature_extractor.1.running_var"])
    with pytest.raises(ValueError, match="MobileNetV3"):
        pretrained_backbone_variables(path, PoolResnet(8, SIZE, 5, 2))


# -- the official checkpoints (skip while they are absent) ---------------------------


def official(*parts):
    path = OFFICIAL.joinpath(*parts)
    if not path.exists():
        pytest.skip("the reference's official checkpoints are not present")
    return path


def reference_forward(path, x_nhwc):
    from fdtpu_torch.compat.torch_import import _register_stub_ops

    _register_stub_ops()
    mod = torch.jit.load(str(path), map_location="cpu").eval()
    with torch.no_grad():
        return mod(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())).numpy()


@pytest.mark.parametrize("parts,make,tol", [
    (("PoolResnet", "medium_model_10x10_480.pth"),
     lambda: PoolResnet(64, (480, 480), 10, 10), dict(atol=2e-5, rtol=1e-4)),
    (("PoolResnet", "small_model_10x10_480.pth"),
     lambda: PoolResnet(32, (480, 480), 10, 10), dict(atol=2e-5, rtol=1e-4)),
    (("Resnet", "medium_model_15x15_480.pth"),
     lambda: Resnet(64, (480, 480), 15, 10), dict(atol=2e-5, rtol=1e-4)),
    (("MobilenetV3Backbone", "medium_model_15x15_480.pth"),
     lambda: MobileNetV3Backbone((480, 480), 15), dict(atol=5e-4, rtol=1e-3)),
])
def test_official_checkpoint_parity(parts, make, tol):
    """The imported model's raw map equals the reference graph's, at the
    tolerances of fdtpu's ``tests/test_compat.py``."""
    path = official(*parts)
    tm = load_torchscript_weights(path, make()).eval()
    x = np.random.default_rng(0).uniform(0, 1, (1, 480, 480, 3)).astype(np.float32)
    got = tm(torch.from_numpy(x)).detach().numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, reference_forward(path, x), **tol)
