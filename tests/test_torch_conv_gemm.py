"""The convolution as one GEMM (``kernels/conv_gemm.py``) against the
convolution it replaces, and the rule that picks it
(``models/layers.narrow_conv``), on the CPU. No jax.

Tolerances: at float32 only the summation order differs (atol 1e-5). At
bfloat16 both sides accumulate in float32 and round once, so they may
differ by one bfloat16 step at the output's scale."""

import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu_torch.kernels.conv_gemm import conv_gemm
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import SSD, Detector, MobileNetV3Backbone, PoolResnet, Resnet, SeparableCNN
from fdtpu_torch.models.layers import conv

# the layers of PoolResnet's body that the form serves, and an input of each
# (B, C, H, W): the stems of the three families that share the body, and
# the 5-channel heads
LAYERS = {
    "poolresnet_stem_480": (lambda: PoolResnet(8, (480, 480), 10, 1).conv1, (1, 3, 480, 480)),
    "poolresnet_stem_320": (lambda: PoolResnet(8, (320, 320), 15, 1).conv1, (2, 3, 320, 320)),
    "poolresnet_stem_160": (lambda: PoolResnet(8, (160, 160), 5, 1).conv1, (2, 3, 160, 160)),
    "resnet_stem": (lambda: Resnet(8, (96, 96), 6, 1).conv1, (2, 3, 96, 96)),
    "separable_stem": (lambda: SeparableCNN(8, (160, 160), 16, 1).conv1, (2, 3, 160, 160)),
    "poolresnet_head": (lambda: PoolResnet(16, (160, 160), 5, 1).out, (1, 16, 15, 15)),
    "resnet_head": (lambda: Resnet(16, (96, 96), 6, 1).out, (1, 16, 6, 6)),
}


def layer_and_input(name: str, bias: bool, dtype: torch.dtype):
    torch.manual_seed(0)
    make, shape = LAYERS[name]
    layer = make()
    if bias:
        with torch.no_grad():
            layer.bias.uniform_(-1.0, 1.0)
    else:
        layer.register_parameter("bias", None)
    layer = layer.to(dtype=dtype, memory_format=torch.channels_last)
    x = torch.rand(shape).to(dtype=dtype, memory_format=torch.channels_last)
    return layer, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_gemm_equals_conv(name, bias, dtype):
    layer, x = layer_and_input(name, bias, dtype)
    with torch.no_grad():
        want = conv(layer, x)
        got = conv_gemm(layer, x)
    assert got.shape == want.shape and got.dtype == dtype
    # channels_last order; a 5-channel output is a view of 8 padded columns
    assert got.stride(1) == 1
    assert got.is_contiguous(memory_format=torch.channels_last) == (got.shape[1] % 8 == 0)
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        step = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())).item() - 7)
        assert err <= step, (err, step)


def test_conv_gemm_reads_the_params_at_the_call():
    """The weight is reshaped inside the call: a change in place shows in
    the next call (a CUDA graph that captured it reads the params by
    address)."""
    layer, x = layer_and_input("poolresnet_head", True, torch.float32)
    with torch.no_grad():
        before = conv_gemm(layer, x)
        layer.weight.mul_(2.0)
        layer.bias.mul_(2.0)
        after = conv_gemm(layer, x)
    torch.testing.assert_close(after, 2.0 * before, atol=1e-5, rtol=0)


def test_exported_conv_gemm_reads_the_strides_at_run_time():
    """An exported program that holds the form, traced on a channels_last
    input, run on an input of another memory format (as a layer's output
    may come out at run time): the windows follow the strides it gets."""
    layer, x = layer_and_input("poolresnet_head", True, torch.float32)

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, t):
            return conv_gemm(self.layer, t)

    with torch.no_grad():
        program = torch.export.export(Head(), (x,)).module()
        for t in (x, x.contiguous()):
            torch.testing.assert_close(program(t), conv(layer, t), atol=1e-5, rtol=0)


def test_conv_gemm_refuses_what_it_does_not_compute():
    x = torch.rand(1, 4, 8, 8)
    for layer in (torch.nn.Conv2d(4, 4, 3, groups=2), torch.nn.Conv2d(4, 4, 3, dilation=2),
                  torch.nn.Conv2d(4, 4, 3, padding="same")):
        with pytest.raises(ValueError, match="conv_gemm takes"):
            conv_gemm(layer, x)


def calls(fn) -> int:
    start = LAUNCHES["conv_gemm"]
    fn()
    return LAUNCHES["conv_gemm"] - start


FAMILIES = {"poolresnet": lambda: PoolResnet(8, (160, 160), 5, 2),
            "resnet": lambda: Resnet(8, (96, 96), 6, 2),
            "separable": lambda: SeparableCNN(8, (160, 160), 16, 2)}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mode,dtype,batch,want", [
    ("no_grad", torch.bfloat16, 1, 2),         # the stem and the head
    ("inference_mode", torch.bfloat16, 1, 2),
    ("no_grad", torch.bfloat16, 4, 2),
    ("no_grad", torch.bfloat16, 5, 1),         # the stem alone: the head's batch is over 4
    ("grad", torch.bfloat16, 1, 0),            # a step that takes gradients
    ("no_grad", torch.float32, 1, 0),
])
def test_the_rule_picks_the_form(family, mode, dtype, batch, want):
    torch.manual_seed(0)
    module = FAMILIES[family]()
    if mode == "grad":  # float32 params, bfloat16 compute: a train step's module
        module.compute_dtype = dtype
    else:
        module = module.to(dtype=dtype, memory_format=torch.channels_last)
    x = torch.rand((batch, *module.input_shape, 3))
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        n = calls(lambda: module(x))
    assert n == want


def test_the_rule_leaves_the_ssd_and_mobilenetv3():
    torch.manual_seed(0)
    for module in (SSD(4, (64, 64), (8, 4, 2, 1), dropout=0.0),
                   MobileNetV3Backbone((96, 96), 3)):
        det = Detector(module.eval(), dtype=torch.bfloat16)
        h, w = module.input_shape
        assert calls(lambda: det.apply(torch.rand((1, h, w, 3)))) == 0, type(module).__name__


def test_summary_counts_the_forms_flops():
    """``Detector.summary_rows``' FLOPs in bfloat16 count the forward as it
    runs (at batch 1): the stem's GEMM as its convolution (K = 300, no
    padding), the head's GEMM with its 5 output columns padded to 8."""
    torch.manual_seed(0)
    module = PoolResnet(16, (160, 160), 5, 2)
    f32 = Detector(module, dtype=torch.float32).summary_rows()[0][4]
    bf16 = Detector(module, dtype=torch.bfloat16).summary_rows()[0][4]
    head_rows, head_k = 5 * 5, 16 * 6 * 6  # the 5x5 grid, k6 over 16 channels
    assert f32 == 8_592_000
    assert bf16 - f32 == 2 * head_rows * head_k * (8 - 5) == 86_400
