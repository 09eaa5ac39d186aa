"""The port's fused residual tail (K6) against fdtpu's Pallas kernel in
interpret mode and its ``reference_tail``, and the ``fused_tail`` eval
forward of PoolResnet.

fdtpu takes ``(B, H, W, C)``; the port takes the same data as ``(B, C, H,
W)``, in channels_last memory (a transposed view) or contiguous.

Tolerances: float32 equal. bfloat16: PyTorch's leaky ReLU multiplies by a
float32 0.2, fdtpu by 0.2 rounded to bfloat16 (0.2001953125), so on a
negative input the two leaky outputs may round one bfloat16 step apart. The
bound is that step passed through the add: on each element one bfloat16
step of ``leaky(c2)`` plus one of the sum (an add that cancels makes it many
steps of the sum), and for a pooled output the largest bound in its window.
Nothing differs where ``c2 >= 0``, and with the slope rounded to bfloat16
the port's op set equals fdtpu's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch
import torch.nn.functional as F

from fdtpu.kernels import epilogue_pallas as jep
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu_torch.bench_pool_fusion import set_fused_tail
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.kernels import epilogue as kep
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import Detector, PoolResnet
from fdtpu_torch.models.layers import DropoutMasks

BF16_SLOPE = 0.2001953125  # 0.2 rounded to bfloat16


def planes(seed, shape=(2, 12, 16, 24), dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    c2 = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 3).astype(dtype)
    skip = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 3).astype(dtype)
    return c2, skip


def to_port(a, layout):
    """fdtpu's NHWC array as the port's NCHW tensor in ``layout``."""
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    t = t.to(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32).permute(0, 3, 1, 2)
    return t.contiguous() if layout == "contiguous" else t


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def bf16_step(x):
    """One bfloat16 step at each float32 value that is a bfloat16."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_fdtpu(dtype, pool, layout):
    c2, skip = planes(int(pool) + 2 * (dtype == "bfloat16"), dtype=jnp.dtype(dtype))
    kernel = np.asarray(jep.fused_residual_tail(c2, skip, pool=pool, interpret=True)
                        .astype(jnp.float32))
    want = np.asarray(jep.reference_tail(c2, skip, pool=pool).astype(jnp.float32))
    np.testing.assert_array_equal(kernel, want)
    tc2, tskip = to_port(c2, layout), to_port(skip, layout)
    got_t = kep.reference_tail(tc2, tskip, pool)
    assert got_t.is_contiguous(memory_format=torch.channels_last if layout == "channels_last"
                               else torch.contiguous_format)
    got = to_nhwc(got_t)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    leaky = to_nhwc(F.leaky_relu(tc2.float(), 0.2))
    flat = np.asarray(jep.reference_tail(c2, skip, pool=False).astype(jnp.float32))
    bound = bf16_step(leaky) + bf16_step(flat)
    bound[np.asarray(c2.astype(jnp.float32)) >= 0] = 0.0
    if pool:
        bound = to_nhwc(F.max_pool2d(torch.from_numpy(bound).permute(0, 3, 1, 2), 2))
    diff = np.abs(got - want)
    assert (diff <= bound).all(), diff.max()
    assert diff.max() > 0  # the slopes do round apart on these inputs
    same_slope = F.leaky_relu(tc2, BF16_SLOPE) + tskip
    if pool:
        same_slope = F.max_pool2d(same_slope, 2)
    np.testing.assert_array_equal(to_nhwc(same_slope), want)


def test_wrapper_on_cpu_runs_the_reference():
    c2, skip = planes(5, dtype=jnp.bfloat16)
    tc2, tskip = to_port(c2, "channels_last"), to_port(skip, "channels_last")
    before = LAUNCHES.copy()
    for pool in (True, False):
        got = kep.fused_residual_tail(tc2, tskip, pool=pool)
        assert torch.equal(got, kep.reference_tail(tc2, tskip, pool))
    assert LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 6, 10)
    with pytest.raises(ValueError, match="even"):
        kep.fused_residual_tail(torch.zeros(2, 8, 5, 10), torch.zeros(2, 8, 5, 10), pool=True)
    kep.fused_residual_tail(torch.zeros(2, 8, 5, 10), torch.zeros(2, 8, 5, 10), pool=False)
    with pytest.raises(ValueError):
        kep.fused_residual_tail(x, torch.zeros(2, 8, 6, 12), pool=False)
    with pytest.raises(TypeError):
        kep.fused_residual_tail(x, x.bfloat16(), pool=False)
    with pytest.raises(TypeError):
        kep.fused_residual_tail(x.double(), x.double(), pool=False)
    with pytest.raises(ValueError, match="channels_last"):
        kep.fused_residual_tail(x, x.contiguous(memory_format=torch.channels_last), pool=True)
    with pytest.raises(ValueError, match="channels_last"):
        kep.fused_residual_tail(x.transpose(2, 3), x.transpose(2, 3), pool=True)
    with pytest.raises(ValueError, match="no kernel"):
        kep.fused_residual_tail(x.to("meta"), x.to("meta"), pool=True)
    c2 = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="eval-only"):
        kep.fused_residual_tail(c2, x, pool=True)
    with torch.no_grad():
        kep.fused_residual_tail(c2, x, pool=True)


def bias_for(seed, c, dtype):
    return jnp.asarray(np.random.default_rng(seed).normal(size=(c,)).astype(np.float32)).astype(dtype)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_operand_matches_fdtpu(dtype, pool, layout):
    """The wrapper's plain version with ``bias`` against fdtpu's
    ``reference_tail`` on ``c2 + bias``: the add rounds to the dtype in
    both, so float32 is equal and bfloat16 differs only by the slope's
    rounding (the module docstring's bound)."""
    c2, skip = planes(10 + int(pool) + 2 * (dtype == "bfloat16"), dtype=jnp.dtype(dtype))
    bias = bias_for(7, c2.shape[-1], jnp.dtype(dtype))
    c2b = c2 + bias  # NHWC: the bias broadcasts over the channel axis
    want = np.asarray(jep.reference_tail(c2b, skip, pool=pool).astype(jnp.float32))
    tc2, tskip = to_port(c2, layout), to_port(skip, layout)
    tbias = torch.from_numpy(np.array(bias.astype(jnp.float32))).to(tc2.dtype)
    got_t = kep.fused_residual_tail(tc2, tskip, pool=pool, bias=tbias)
    assert got_t.dtype == tc2.dtype
    assert got_t.is_contiguous(memory_format=torch.channels_last if layout == "channels_last"
                               else torch.contiguous_format)
    tc2b = tc2 + tbias.view(1, -1, 1, 1)
    np.testing.assert_array_equal(to_nhwc(tc2b), np.asarray(c2b.astype(jnp.float32)))
    got = to_nhwc(got_t)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    leaky = to_nhwc(F.leaky_relu(tc2b.float(), 0.2))
    flat = np.asarray(jep.reference_tail(c2b, skip, pool=False).astype(jnp.float32))
    bound = bf16_step(leaky) + bf16_step(flat)
    bound[np.asarray(c2b.astype(jnp.float32)) >= 0] = 0.0
    if pool:
        bound = to_nhwc(F.max_pool2d(torch.from_numpy(bound).permute(0, 3, 1, 2), 2))
    diff = np.abs(got - want)
    assert (diff <= bound).all(), diff.max()
    same_slope = F.leaky_relu(tc2b, BF16_SLOPE) + tskip
    if pool:
        same_slope = F.max_pool2d(same_slope, 2)
    np.testing.assert_array_equal(to_nhwc(same_slope), want)


def test_bias_rounds_before_the_tail():
    """``c2 + bias`` is rounded to bfloat16 before the leaky ReLU, as the
    eager bias add after a cuDNN convolution rounds it; adding in float32
    and rounding once would differ on these inputs."""
    c2, skip = planes(21, dtype=jnp.bfloat16)
    tc2, tskip = to_port(c2, "channels_last"), to_port(skip, "channels_last")
    tbias = torch.from_numpy(np.random.default_rng(3).normal(size=tc2.shape[1]) * 3).bfloat16()
    got = kep.fused_residual_tail(tc2, tskip, pool=False, bias=tbias)
    eager = F.leaky_relu(tc2 + tbias.view(1, -1, 1, 1), 0.2) + tskip
    assert torch.equal(got, eager)
    unrounded = (F.leaky_relu(tc2.float() + tbias.float().view(1, -1, 1, 1), 0.2)
                 + tskip.float()).bfloat16()
    assert not torch.equal(got, unrounded)


def test_wrapper_rejects_a_bad_bias():
    x = torch.zeros(2, 8, 6, 10)
    kep.fused_residual_tail(x, x, pool=True, bias=torch.zeros(8))
    with pytest.raises(ValueError, match="bias must be"):
        kep.fused_residual_tail(x, x, pool=True, bias=torch.zeros(9))
    with pytest.raises(ValueError, match="bias must be"):
        kep.fused_residual_tail(x, x, pool=True, bias=torch.zeros(1, 8))
    with pytest.raises(TypeError, match="bias must be"):
        kep.fused_residual_tail(x, x, pool=True, bias=torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bias lies on"):
        kep.fused_residual_tail(x, x, pool=True, bias=torch.zeros(8, device="meta"))
    b = torch.zeros(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        kep.fused_residual_tail(x, x, pool=True, bias=b)
    with torch.no_grad():
        kep.fused_residual_tail(x, x, pool=True, bias=b)


def small_pair():
    """fdtpu's PoolResnet (filters 16, 2 blocks, 160 px) and the port's with
    its params and ``fused_tail``."""
    jm = JaxPoolResnet(filters=16, input_shape=(160, 160), num_patches=5, num_residual_blocks=2,
                       dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 160, 160, 3)))
    tm = PoolResnet(16, (160, 160), 5, 2, fused_tail=True)
    tm.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"])))
    return jm, variables, tm.eval()


def test_fused_tail_forward_equals_eager_and_fdtpu():
    jm, variables, tm = small_pair()
    x = np.random.default_rng(0).uniform(0, 1, size=(2, 160, 160, 3)).astype(np.float32)
    assert [b.fused_tail for b in tm.residual_blocks] == [True, True]
    assert tm.residual_blocks[0].pool_until == 10  # block 0 pools 20 -> 10, block 1 does not
    with torch.no_grad():
        fused = tm(torch.from_numpy(x))
        set_fused_tail(tm, False)
        eager = tm(torch.from_numpy(x))
    assert torch.equal(fused, eager)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(fused.numpy(), want, atol=2e-5, rtol=0)
    # the Detector's bfloat16 channels_last copy, fused against eager
    det = Detector(tm)
    set_fused_tail(det.net, True)
    fused16 = det.apply(torch.from_numpy(x))
    set_fused_tail(det.net, False)
    assert torch.equal(fused16, det.apply(torch.from_numpy(x)))


def test_fused_tail_is_eval_only():
    _, _, tm = small_pair()
    x = torch.rand(2, 160, 160, 3)
    with pytest.raises(ValueError, match="dropout masks"), torch.no_grad():
        tm(x, DropoutMasks(torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="eval-only"):
        tm(x)  # the params require grad


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)

    def operands(shape, dt, fmt, offset=0):
        n, c, h, w = shape
        flat = torch.randn((n * c * h * w + offset,), generator=g, device="cuda").to(dt)[offset:]
        if fmt == torch.channels_last:
            return flat.view(n, h, w, c).permute(0, 3, 1, 2)
        return flat.view(shape)

    # 32 channels; C = 12 (not a multiple of 8); numel 945 (not a multiple of 8)
    for shape in ((4, 32, 20, 20), (4, 12, 20, 20), (3, 5, 7, 9)):
        for dt in (torch.float32, torch.bfloat16):
            for fmt in (torch.channels_last, torch.contiguous_format):
                bias = torch.randn((shape[1],), generator=g, device="cuda").to(dt)
                for offset in (0, 1):  # 1: both inputs off the 16-byte grid
                    c2, skip = operands(shape, dt, fmt, offset), operands(shape, dt, fmt, offset)
                    for pool in (True, False):
                        if pool and shape[2] % 2:
                            continue
                        for b in (None, bias):
                            assert torch.equal(kep.fused_residual_tail(c2, skip, pool=pool, bias=b),
                                               kep.reference_tail(c2, skip, pool, b))
