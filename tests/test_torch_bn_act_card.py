"""On a card (``gpu``; skipped without one): the fused BatchNorm epilogue
(``kernels/bn_act.py``, ``csrc/bn_act.cu``) bit-equal to the eager chain it
replaces (``F.batch_norm`` by the running statistics, ``+ skip``, ReLU or
LeakyReLU, on ATen's own BatchNorm kernel: PyTorch's in bfloat16; in
float32, where PyTorch would pick cuDNN's, with cuDNN off) on random,
non-trivial BatchNorm params and statistics, at every chain the served
RetinaFace-R50 runs at 840 px and at shapes that take the kernel's scalar
path; the route (``layers.bn_act``) launching the kernel in bfloat16 and
float32, raising where the kernel would, and running the eager ops only
under autograd; the whole 840 px ``Detector`` the same with the route on
and off, in bfloat16 and in float32 (the eager BatchNorm with cuDNN off);
73 launches a RetinaFace predict replay and none in PoolResnet's or the
SSD's. No jax here, so the file runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_bn_act_card.py``.
``chip_smoke.py`` phase 25 times the kernel at the served shapes."""

import numpy as np
import pytest
import torch

from fdtpu_torch.kernels import bn_act as kbn
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import Detector, build_model, layers
from fdtpu_torch.utils.config import DetectorConfig, RetinaFaceConfig, SSDConfig

ACTS = {"none": None, "relu": 0.0, "leaky": 0.1}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bn_params(c: int, device, seed: int):
    """Weight, bias, running mean and variance far from the identity
    BatchNorm (variance over four decades)."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(c, generator=gen) * 1.5
    b = torch.randn(c, generator=gen)
    mean = torch.randn(c, generator=gen)
    var = 10.0 ** (torch.rand(c, generator=gen) * 4 - 2)
    return tuple(t.to(device) for t in (w, b, mean, var))


def activation(shape, dtype, device, seed: int, offset: int = 0) -> torch.Tensor:
    """A channels_last ``(N, C, H, W)`` tensor of N(0, 4) values, its data
    ``offset`` elements into its storage."""
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    flat = (torch.randn(offset + n * h * w * c, generator=gen) * 2).to(dtype).to(device)
    return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def assert_bit_equal(got, want, what):
    diff = int((bits(got) != bits(want)).sum())
    assert diff == 0, f"{what}: {diff} of {want.numel()} elements differ"


def served_chains(device) -> list[tuple]:
    """``(shape, act, skip)`` of each ``layers.bn_act`` call of the served
    RetinaFace-R50's bf16 forward at 840 px, in call order."""
    calls = []
    real = layers.fused_bn_act

    def record(y, *args):  # args: weight, bias, mean, var, eps, act, skip
        calls.append((tuple(y.shape), args[5], args[6] is not None))
        return real(y, *args)

    det = Detector(build_model("retinaface", RetinaFaceConfig(), device,
                               torch.Generator().manual_seed(0)))
    layers.fused_bn_act = record
    try:
        det.apply(torch.rand((1, 840, 840, 3), device=device))
    finally:
        layers.fused_bn_act = real
    return calls


@pytest.fixture(scope="module")
def chains():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return served_chains(torch.device("cuda"))


def run_both(shape, dtype, act, with_skip, device, seed, offset=0):
    params = bn_params(shape[1], device, seed)
    y = activation(shape, dtype, device, seed + 1, offset)
    skip = activation(shape, dtype, device, seed + 2, offset) if with_skip else None
    with torch.inference_mode():
        start = LAUNCHES["bn_act"]
        got = kbn.fused_bn_act(y, *params, 1e-5, act, skip)
        assert LAUNCHES["bn_act"] == start + 1
        with torch.backends.cudnn.flags(enabled=False):
            want = kbn.reference_bn_act(y, *params, 1e-5, act, skip)
        if dtype == torch.bfloat16:  # PyTorch's own choice: ATen's kernel too
            assert_bit_equal(kbn.reference_bn_act(y, *params, 1e-5, act, skip), want, "cuDNN")
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_served_chains_bit_equal(card, chains, dtype):
    """Every distinct chain of the served forward (73 calls) with each
    activation, with and without a skip."""
    assert len(chains) == 73
    shapes = sorted({c[0] for c in chains})
    for i, shape in enumerate(shapes):
        for act_name, act in ACTS.items():
            for with_skip in (False, True):
                got, want = run_both(shape, dtype, act, with_skip, card, seed=100 * i)
                assert_bit_equal(got, want, f"{shape} {dtype} {act_name} skip={with_skip}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", [
    {"shape": (2, 36, 7, 9)},  # C not a multiple of the 16-byte group: scalar path
    {"shape": (1, 64, 13, 11), "offset": 1},  # data one element off 16-byte alignment
    {"shape": (3, 2048, 5, 3)},  # more groups than a block's threads
    {"shape": (2, 4, 9, 7)},  # fewer channels than a group: scalar path
    {"shape": (1, 8, 1, 1)},  # one row
], ids=["c36", "offset", "wide", "c4", "one-row"])
def test_scalar_path_and_odd_shapes_bit_equal(card, dtype, case):
    for act_name, act in ACTS.items():
        for with_skip in (False, True):
            got, want = run_both(case["shape"], dtype, act, with_skip, card, seed=7,
                                 offset=case.get("offset", 0))
            assert_bit_equal(got, want, f"{case} {act_name} skip={with_skip}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_route_launches_the_kernel(card, dtype):
    """``layers.bn_act`` without autograd: one launch in either dtype, also
    with grad enabled on frozen params, bit-equal to the eager ops (cuDNN
    off in float32)."""
    bn = layers.BatchNorm(64, eps=1e-5).to(card).requires_grad_(False)
    with torch.no_grad():
        for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        bn_params(64, card, 11)):
            p.copy_(v)
    y = activation((1, 64, 27, 27), dtype, card, 12)
    skip = activation((1, 64, 27, 27), dtype, card, 13)
    start = LAUNCHES["bn_act"]
    got = layers.bn_act(bn, y, 0.0, skip)
    assert LAUNCHES["bn_act"] == start + 1
    with torch.backends.cudnn.flags(enabled=False):
        want = kbn.reference_bn_act(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                    bn.eps, 0.0, skip)
    assert_bit_equal(got, want, f"route {dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["NCHW", "skip NCHW", "channel slice", "float16"])
def test_route_raises_on_the_card_where_the_kernel_would(card, case):
    """No eager fallback on the card: the wrapper's refusal reaches the
    caller, and nothing launches."""
    bn = layers.BatchNorm(64, eps=1e-5).to(card)
    y = activation((1, 64, 9, 9), torch.bfloat16, card, 14)
    skip = y.contiguous() if case == "skip NCHW" else None
    y = {"NCHW": y.contiguous(), "channel slice": torch.cat([y, y], 1)[:, :64],
         "float16": y.half()}.get(case, y)
    start = LAUNCHES["bn_act"]
    with torch.no_grad(), pytest.raises(TypeError if case == "float16" else ValueError):
        layers.bn_act(bn, y, 0.0, skip)
    assert LAUNCHES["bn_act"] == start


@pytest.mark.gpu
def test_route_under_autograd_runs_the_eager_ops(card):
    bn = layers.BatchNorm(64, eps=1e-5).to(card)
    y = activation((2, 64, 9, 9), torch.float32, card, 15)
    start = LAUNCHES["bn_act"]
    got = layers.bn_act(bn, y, 0.1)
    assert LAUNCHES["bn_act"] == start and got.requires_grad
    assert torch.equal(got, kbn.reference_bn_act(y, bn.weight, bn.bias, bn.running_mean,
                                                 bn.running_var, bn.eps, 0.1))
    got.sum().backward()
    assert bn.weight.grad is not None


def random_statistics(module: torch.nn.Module, seed: int) -> None:
    """Every BatchNorm of ``module`` off the identity, mildly, so that the
    activations stay finite through the 53-layer body."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))


@pytest.mark.gpu
def test_predict_same_with_the_route_on_and_off(card, monkeypatch):
    """The 840 px bf16 Detector on random BatchNorm statistics: the raw rows
    and ``predict``'s boxes, mask and landmarks bit-equal with the fused
    epilogue and with the eager chain; 73 launches a predict replay with the
    route on, none with it off."""
    module = build_model("retinaface", RetinaFaceConfig(), card, torch.Generator().manual_seed(1))
    random_statistics(module, 2)
    frame = np.random.default_rng(3).integers(0, 256, size=(840, 840, 3), dtype=np.uint8)
    norm = torch.from_numpy(frame).to(card).float()[None] / 255.0
    on = Detector(module, 0.6, 0.4, 750)
    rows_on, pred_on = on.apply(norm), on.predict(frame)
    (g_on,) = on._graphs.graphs.values()
    monkeypatch.setattr(layers, "fused_bn_act", kbn.reference_bn_act)
    off = Detector(module, 0.6, 0.4, 750)
    rows_off, pred_off = off.apply(norm), off.predict(frame)
    (g_off,) = off._graphs.graphs.values()
    assert (g_on.per_replay["bn_act"], g_off.per_replay["bn_act"]) == (73, 0)
    assert_bit_equal(rows_on, rows_off, "rows")
    for a, b in zip((*pred_on, pred_on.landmarks), (*pred_off, pred_off.landmarks)):
        assert torch.equal(a, b)
    print(f"{int(pred_on[2].sum())} kept")


@pytest.mark.gpu
def test_float32_detector_through_the_kernel(card, monkeypatch):
    """A float32 840 px Detector launches the kernel 73 times a predict
    replay too, and its rows equal the eager chain's bit for bit where that
    chain's BatchNorm runs with cuDNN off (ATen's kernel, whose roundings
    the kernel follows; the convolutions are cuDNN's in both)."""
    module = build_model("retinaface", RetinaFaceConfig(), card, torch.Generator().manual_seed(4))
    random_statistics(module, 5)
    frame = np.random.default_rng(6).integers(0, 256, size=(840, 840, 3), dtype=np.uint8)
    norm = torch.from_numpy(frame).to(card).float()[None] / 255.0
    on = Detector(module, 0.6, 0.4, 750, torch.float32)
    on.predict(frame)
    (g_on,) = on._graphs.graphs.values()
    assert g_on.per_replay["bn_act"] == 73
    rows_on = on.apply(norm)

    def aten_chain(*args):
        with torch.backends.cudnn.flags(enabled=False):
            return kbn.reference_bn_act(*args)

    monkeypatch.setattr(layers, "fused_bn_act", aten_chain)
    rows_off = Detector(module, 0.6, 0.4, 750, torch.float32).apply(norm)
    assert_bit_equal(rows_on, rows_off, "float32 rows")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["poolresnet", "ssd"])
def test_other_families_launch_none(card, family):
    cfg = DetectorConfig() if family == "poolresnet" else SSDConfig()
    det = Detector(build_model(family, cfg, card, torch.Generator().manual_seed(0)))
    det.predict(np.zeros((480, 480, 3), np.uint8))
    (g,) = det._graphs.graphs.values()
    assert g.per_replay["bn_act"] == 0
