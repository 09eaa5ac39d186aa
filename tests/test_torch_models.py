"""The port's PoolResnet against fdtpu's, from the same params.

fdtpu's params are carried across with ``poolresnet_state_dict``; the same
numpy images go to both forwards (eval mode, dropout off).

Tolerances: at float32 the bar is PARITY.md §2.3's ``atol=2e-5`` (measured
~2e-7: only the summation order of the convolutions differs). At bfloat16
both sides compute in bfloat16, but XLA and torch round intermediate
results at different places (XLA fuses conv bias, leaky ReLU and the skip
add; torch rounds after each op), so single activations may differ by a
bfloat16 step, 2^-8 relative. The gate is ``atol=2^-7`` on the sigmoid
output, two bfloat16 steps at unit scale; measured ~1.5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.utils.config import DetectorConfig as JaxDetectorConfig
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import SSD, Detector, PoolResnet, build_model
from fdtpu_torch.utils.config import DetectorConfig

SIZE = (160, 160)
BF16_ATOL = 2.0 ** -7


def convert(variables) -> dict:
    return poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"]))


def pair(filters=16, blocks=2, patches=5, dtype=jnp.float32, fast_stem=False, seed=1):
    """An fdtpu model with fresh params, and the port's model carrying them."""
    jm = JaxPoolResnet(
        filters=filters, input_shape=SIZE, num_patches=patches,
        num_residual_blocks=blocks, dtype=dtype, fast_stem=fast_stem,
    )
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SIZE, 3)))
    tm = PoolResnet(filters, SIZE, patches, blocks)
    tm.load_state_dict(convert(variables))
    return jm, variables, tm


def images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(b, *SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(input_shape=(480, 480), num_patches=10, num_residual_blocks=10),
        dict(input_shape=(320, 320), num_patches=15, num_residual_blocks=10),
        dict(input_shape=(160, 160), num_patches=5, num_residual_blocks=2),
        dict(input_shape=(480, 480), num_patches=10, num_residual_blocks=4,
             output_kernel_size=3, output_padding=1),
        dict(input_shape=(256, 256), num_patches=8, num_residual_blocks=3,
             input_kernel_size=6, input_stride=4),
    ],
)
def test_grid_size_matches_fdtpu(kw):
    jm = JaxPoolResnet(filters=8, **kw)
    tm = PoolResnet(8, **kw)
    assert tm.grid_size() == jm.grid_size()


@pytest.mark.parametrize("filters,blocks", [(16, 2), (8, 1)])
def test_forward_f32_matches_fdtpu(filters, blocks):
    jm, variables, tm = pair(filters, blocks)
    x = images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 5, 5, 5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_forward_bf16_matches_fdtpu():
    jm, variables, tm = pair(dtype=jnp.bfloat16)
    x = images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    det = Detector(tm, dtype=torch.bfloat16)
    got = det.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert det.net.conv1.weight.dtype == torch.bfloat16
    assert tm.conv1.weight.dtype == torch.float32  # the master stays float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_forward_bf16_no_grad_matches_fdtpu():
    """The serving copy's forward under ``no_grad``, where the stem, and the
    head up to batch 4, run as one GEMM each (``layers.narrow_conv``), stays
    within the same 2^-7 of fdtpu."""
    jm, variables, tm = pair(dtype=jnp.bfloat16)
    det = Detector(tm, dtype=torch.bfloat16)
    for b, gemms in ((1, 2), (5, 1)):
        x = images(b=b, seed=b)
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        start = LAUNCHES["conv_gemm"]
        with torch.no_grad():
            got = det.net(torch.from_numpy(x))
        assert LAUNCHES["conv_gemm"] - start == gemms
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_fast_stem_params_load():
    """fdtpu's two-stage stem has the plain stem's param tree: its params
    load into the port's plain stem and give the same forward."""
    jm, variables, tm = pair(fast_stem=True)
    x = images(seed=3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_state_dict_names_and_layout():
    _, variables, tm = pair(filters=8, blocks=2)
    sd = convert(variables)
    assert set(sd) == set(tm.state_dict())
    assert "residual_blocks.1.conv2.weight" in sd and "out.bias" in sd
    kernel = np.asarray(variables["params"]["Conv_0"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        poolresnet_state_dict({**variables["params"], "Dense_0": {}})


def test_config_duplicates_fdtpu():
    assert DetectorConfig() == DetectorConfig(**vars(JaxDetectorConfig()))
    assert DetectorConfig().image_size == JaxDetectorConfig().image_size


def test_build_model_families():
    cfg = DetectorConfig(filters=8, input_shape=SIZE, num_patches=5, num_residual_blocks=1)
    a = build_model("poolresnet", cfg, "cpu", torch.Generator().manual_seed(0))
    b = build_model("poolresnet", cfg, "cpu", torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert p.dtype == torch.float32 and torch.equal(p, q), name
    assert a.grid_size() == 5
    ssd = build_model("ssd", cfg, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(ssd, SSD) and ssd.patch_sizes == (20, 10, 5, 2)  # from the input shape
    # torch's default init, as fdtpu's SSD (tests/test_models.py's
    # test_ssd_default_init_is_torch): uniform kernel and bias within
    # 1/sqrt(fan_in), and initial scores spread, not pinned at 0.5
    bound = 1 / 27 ** 0.5  # the stem's fan_in: 3 x 3 x 3
    assert ssd.stem.bias.abs().max() <= bound and ssd.stem.bias.abs().max() > 0
    assert ssd.stem.weight.abs().max() <= bound
    assert ssd.heads[0].bias.abs().max() <= 1 / ssd.heads[0].in_features ** 0.5
    scores = ssd.eval()(torch.zeros(1, *SIZE, 3))[0, :, 0]
    assert scores.std() > 1e-3
    # the rest of the zoo (ROADMAP.md queue 1, item 4) builds too, on the CPU when asked
    resnet = build_model("resnet", cfg, "cpu", torch.Generator().manual_seed(0))
    assert type(resnet).__name__ == "Resnet" and resnet.grid_size() == 40  # 80 -> 40, one block
    with pytest.raises(ValueError):
        build_model("nope", cfg)


def test_lecun_init_scale():
    """Weights follow fdtpu's default init: std sqrt(1/fan_in), zero bias."""
    cfg = DetectorConfig(filters=64, num_residual_blocks=1)
    m = build_model("poolresnet", cfg, "cpu", torch.Generator().manual_seed(0))
    w = m.residual_blocks[0].conv1.weight
    assert abs(w.std().item() - (1 / (64 * 9)) ** 0.5) < 2e-3
    assert not m.residual_blocks[0].conv1.bias.any()


def test_build_model_defaults_to_the_card():
    """With no ``device`` the module is built on the card; without a card
    that raises instead of falling back to the CPU."""
    cfg = DetectorConfig(filters=8, input_shape=SIZE, num_patches=5, num_residual_blocks=1)
    if torch.cuda.is_available():
        assert build_model("poolresnet", cfg).conv1.weight.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_model("poolresnet", cfg)
