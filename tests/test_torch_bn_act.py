"""The fused BatchNorm epilogue's wrapper (``kernels/bn_act.py``) and its
route (``models/layers.bn_act``) on the CPU, where both run the eager
chain: exactly what ``BatchNorm``, ``+ skip`` and the activation gave
before, with and without autograd; the route through the wrapper wherever
no backward is needed, and the wrapper's refusals reaching its caller; the
operands the kernel does not take refused; SSH's branches, ReLU'd, equal
to ReLU after ``torch.cat``; each of RetinaFace's BatchNorms through the
wrapper once a forward. No jax. The kernel itself is held to the eager
chain on a card (``tests/test_torch_bn_act_card.py``)."""

import collections
import types

import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch
import torch.nn.functional as F

from fdtpu_torch.kernels import bn_act as kbn
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import layers
from fdtpu_torch.models import build_model
from fdtpu_torch.models.retinaface import SSH
from fdtpu_torch.utils import graphs
from fdtpu_torch.utils.config import RetinaFaceConfig

ACTS = {"none": None, "relu": 0.0, "leaky": 0.1}
SHAPE = (2, 16, 5, 7)


def random_bn(c: int, seed: int = 0) -> layers.BatchNorm:
    gen = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(c, generator=gen))
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(10.0 ** (torch.rand(c, generator=gen) * 4 - 2))
    return bn


def channels_last(shape, dtype=torch.float32, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 2
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def eager(bn, y, act, skip):
    """The chain as RetinaFace ran it before the route."""
    x = bn(y)
    if skip is not None:
        x = x + skip
    if act is None:
        return x
    return F.leaky_relu(x, act) if act else F.relu(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("act", list(ACTS.values()), ids=list(ACTS))
@pytest.mark.parametrize("with_skip", [False, True], ids=["", "skip"])
def test_route_on_the_cpu_is_the_eager_chain(dtype, grad, act, with_skip):
    bn = random_bn(SHAPE[1])
    y = channels_last(SHAPE, dtype, 1)
    skip = channels_last(SHAPE, dtype, 2) if with_skip else None
    with torch.set_grad_enabled(grad):
        got = layers.bn_act(bn, y, act, skip)
        want = eager(bn, y, act, skip)
    assert got.dtype == dtype and got.requires_grad == grad
    assert torch.equal(got, want)
    if grad:  # the route keeps the graph to the BatchNorm's params
        got.sum().backward()
        assert bn.weight.grad is not None


@pytest.mark.parametrize("act", list(ACTS.values()), ids=list(ACTS))
@pytest.mark.parametrize("with_skip", [False, True], ids=["", "skip"])
def test_wrapper_on_the_cpu_runs_the_reference(act, with_skip):
    bn = random_bn(SHAPE[1])
    y = channels_last(SHAPE, torch.bfloat16, 1)
    skip = channels_last(SHAPE, torch.bfloat16, 2) if with_skip else None
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    start = LAUNCHES.copy()
    with torch.no_grad():
        got = kbn.fused_bn_act(y, *params, bn.eps, act, skip)
        assert torch.equal(got, eager(bn, y, act, skip))
        assert torch.equal(got, kbn.reference_bn_act(y, *params, bn.eps, act, skip))
    assert LAUNCHES == start  # no kernel on the CPU


def bad_operands():
    """(label, y, skip, params, act, error) the wrapper refuses."""
    c = SHAPE[1]
    y = channels_last(SHAPE)
    params = (torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c))
    return [
        ("3-dim", y[0], None, params, None, ValueError),
        ("float16", y.half(), None, params, None, TypeError),
        ("int", y.int(), None, params, None, TypeError),
        ("NCHW", y.contiguous(), None, params, None, ValueError),
        ("channel slice", torch.cat([y, y], 1)[:, :c], None, params, None, ValueError),
        ("skip NCHW", y, y.contiguous(), params, None, ValueError),
        ("skip shape", y, y[:, :8], params, None, ValueError),
        ("skip dtype", y, y.bfloat16(), params, None, ValueError),
        ("params bf16", y, None, tuple(p.bfloat16() for p in params), None, ValueError),
        ("params length", y, None, (torch.ones(c + 1), *params[1:]), None, ValueError),
        ("params strided", y, None, (torch.ones(2 * c)[::2], *params[1:]), None, ValueError),
        ("params device", y, None, (params[0].to("meta"), *params[1:]), None, ValueError),
        ("negative slope", y, None, params, -0.1, ValueError),
        ("int act", y, None, params, 0, ValueError),
        ("meta device", y.to("meta"), None, tuple(p.to("meta") for p in params), None,
         ValueError),
    ]


@pytest.mark.parametrize("case", bad_operands(), ids=lambda c: c[0] if isinstance(c, tuple) else "")
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _, y, skip, params, act, error = case
    with torch.no_grad(), pytest.raises(error):
        kbn.fused_bn_act(y, *params, 1e-5, act, skip)


def test_wrapper_refuses_a_grad_requiring_input():
    c = SHAPE[1]
    params = (torch.ones(c, requires_grad=True), torch.zeros(c), torch.zeros(c), torch.ones(c))
    y = channels_last(SHAPE)
    with pytest.raises(RuntimeError, match="eval-only"):
        kbn.fused_bn_act(y, *params, 1e-5)
    frozen = tuple(p.detach() for p in params)
    with pytest.raises(RuntimeError, match="eval-only"):
        kbn.fused_bn_act(y.requires_grad_(), *frozen, 1e-5)
    with torch.no_grad():  # no backward wanted
        kbn.fused_bn_act(y, *params, 1e-5)


@pytest.mark.parametrize("case", ["no_grad", "frozen", "autograd_y", "autograd_params"])
def test_route_takes_the_wrapper_unless_autograd_needs_a_backward(case, monkeypatch):
    """The route calls the wrapper (a launch on a card) wherever no backward
    is needed, also with grad enabled on frozen params, and the eager ops
    only under autograd."""
    bn = random_bn(SHAPE[1])
    y = channels_last(SHAPE)
    if case != "autograd_params":
        bn.requires_grad_(False)
    if case == "autograd_y":
        y.requires_grad_()
    calls = []

    def record(*args):
        calls.append(args)
        return kbn.fused_bn_act(*args)

    monkeypatch.setattr(layers, "fused_bn_act", record)
    with torch.set_grad_enabled(case != "no_grad"):
        got = layers.bn_act(bn, y, 0.0)
    assert len(calls) == (1 if case in ("no_grad", "frozen") else 0)
    assert torch.equal(got, eager(bn, y, 0.0, None))


@pytest.mark.parametrize("case", ["NCHW", "skip NCHW", "float16"])
def test_route_raises_where_the_kernel_would(case):
    """Without autograd the wrapper's refusal reaches the caller: nothing
    runs the eager ops in its place."""
    bn = random_bn(SHAPE[1])
    y = channels_last(SHAPE)
    skip = y.contiguous() if case == "skip NCHW" else None
    y = {"NCHW": y.contiguous(), "float16": y.half()}.get(case, y)
    with torch.no_grad(), pytest.raises(TypeError if case == "float16" else ValueError):
        layers.bn_act(bn, y, 0.0, skip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("leaky", [0.0, 0.1], ids=["relu", "leaky"])
def test_ssh_equals_relu_after_cat(dtype, leaky):
    """SSH's three branches, each ReLU'd by its BatchNorm's epilogue, then
    concatenated, equal ``F.relu(torch.cat(...))``, the published order, bit
    for bit."""
    torch.manual_seed(0)
    ssh = SSH(32, 32, leaky).to(dtype=dtype, memory_format=torch.channels_last).eval()
    for m in ssh.modules():
        if isinstance(m, layers.BatchNorm):
            m.float().load_state_dict(random_bn(m.weight.shape[0], m.weight.shape[0]).state_dict())
    x = channels_last((2, 32, 9, 11), dtype, 3)
    with torch.no_grad():
        got = ssh(x)
        c5_1 = eager(ssh.conv5X5_1[1], layers.conv(ssh.conv5X5_1[0], x), leaky, None)
        c7_2 = eager(ssh.conv7X7_2[1], layers.conv(ssh.conv7X7_2[0], c5_1), leaky, None)
        branches = [eager(m[1], layers.conv(m[0], inp), None, None)
                    for m, inp in ((ssh.conv3X3, x), (ssh.conv5X5_2, c5_1), (ssh.conv7x7_3, c7_2))]
        want = F.relu(torch.cat(branches, dim=1))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_graphs_count_the_epilogue():
    """A replay of a graph that captured the epilogue adds its launches to
    ``LAUNCHES`` by name, as the wrapper does where it runs."""
    g = graphs.Graph(types.SimpleNamespace(replay=lambda: None), (), (),
                     collections.Counter(bn_act=73), 0, 0.0)
    start = LAUNCHES.copy()
    g.replay()
    g.replay()
    assert LAUNCHES - start == collections.Counter(bn_act=146)


def test_each_batchnorm_through_the_wrapper_once(monkeypatch):
    """A no-grad RetinaFace forward on the CPU sends each of its BatchNorms'
    chains through the wrapper once (73 at the published depth), every
    operand channels_last (the wrapper would raise otherwise)."""
    cfg = RetinaFaceConfig(input_shape=(64, 64), in_channels=(32, 64, 128), out_channel=72)
    net = build_model("retinaface", cfg, "cpu")
    net = net.to(memory_format=torch.channels_last).eval()
    calls = []

    def record(*args):
        calls.append(args)
        return kbn.fused_bn_act(*args)

    monkeypatch.setattr(layers, "fused_bn_act", record)
    with torch.no_grad():
        net(torch.rand(1, 64, 64, 3))
    assert len(calls) == sum(isinstance(m, layers.BatchNorm) for m in net.modules()) == 73
