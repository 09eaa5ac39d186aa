"""The deployment slice's export: K1 as the registered op
``fdtpu_torch::decode_filter_nms``, and the predict program through
``torch.export``, port against fdtpu (float32, the same converted params).

The op's CPU implementation is the plain version, bit-equal to fdtpu's K1 in
interpret mode. The exported program holds one K1 node; saved and loaded,
it equals fdtpu's StableHLO artifact (``fdtpu.export``) on the same frames:
the kept rows equal in number and order, within fdtpu's export tolerance,
1e-3 px. fdtpu's artifact decodes with its XLA NMS (``fdtpu.core.nms``),
which leaves a suppressed row in place, masked, where K1 compacts the kept
rows; so the rows are compared compacted. The thresholds keep every
candidate inside the capacity, where the XLA decode (top-``capacity``
first) and K1 agree.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.compat.torch_import import ReferenceLayoutGrid as JaxReferenceLayoutGrid
from fdtpu.core.nms import decode_filter_nms as xla_decode_filter_nms
from fdtpu.export import export_predict as jax_export_predict
from fdtpu.export import load_exported as jax_load_exported
from fdtpu.kernels import grid_decode_tables as jax_grid_tables
from fdtpu.kernels import pallas_decode_filter_nms_batch
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu_torch.compat import ReferenceLayoutGrid, poolresnet_state_dict, ssd_state_dict
from fdtpu_torch.core import compact_boxes
from fdtpu_torch.export import (
    PredictProgram,
    aot_compile_predict,
    export_predict,
    export_program,
    load_exported,
)
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.models import SSD, PoolResnet

REPO = Path(__file__).resolve().parents[1]
PROB, IOU, CAP = 0.45, 0.3, 128  # capacity above every candidate count here
EXPORT_ATOL = 1e-3  # px, fdtpu's export round trip (tests/test_compat.py)
OP = torch.ops.fdtpu_torch.decode_filter_nms.default


def assert_same_rows(boxes, mask, jboxes, jmask):
    """Per image, the kept rows of the port's ``(boxes, mask)`` equal
    fdtpu's in number and order, within the export tolerance."""
    for i in range(len(mask)):
        got = compact_boxes(boxes[i], mask[i])
        want = compact_boxes(np.asarray(jboxes[i]), np.asarray(jmask[i]))
        assert got.shape == want.shape, (i, got, want)
        np.testing.assert_allclose(got, want, atol=EXPORT_ATOL, rtol=0)


def op_nodes(graph) -> int:
    return sum(n.target is OP for n in graph.nodes)


def grid_values(seed, b, s):
    return np.random.default_rng(seed).uniform(0, 1, (b, s * s, 5)).astype(np.float32)


# -- the op ----------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,prob,iou,cap", [(1, 10, 0.5, 0.5, 128), (4, 10, 0.7, 0.01, 64),
                                              (3, 15, 0.5, 0.3, 8)])
def test_op_cpu_equals_plain_and_fdtpu_k1(b, s, prob, iou, cap):
    """The op on CPU tensors is the plain version, and fdtpu's K1 (interpret
    mode) bit for bit."""
    values = grid_values(b * s, b, s)
    tables = knms.grid_decode_tables(s, (480, 480))
    cols = [torch.from_numpy(c) for c in tables[:4]]
    w, h = tables[4:]
    got = torch.ops.fdtpu_torch.decode_filter_nms(
        torch.from_numpy(values), *cols, *(knms._f32(v) for v in (w, h, prob, iou)), cap)
    plain = knms.decode_filter_nms_reference(torch.from_numpy(values), (*cols, w, h), prob, iou,
                                             cap)
    jb, jm = pallas_decode_filter_nms_batch(jnp.asarray(values), jax_grid_tables(s, (480, 480)),
                                            prob, iou, cap, interpret=True)
    for g, p_, j in zip(got, plain, (jb, jm)):
        assert torch.equal(g, p_)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_op_cpu_equals_fdtpu_xla_decode():
    """Under the capacity fdtpu's XLA decode (``fdtpu.core.nms``) gives the
    same rows as the op."""
    s, cap = 10, 128
    values = grid_values(7, 3, s)
    boxes, mask = knms.decode_filter_nms_batch(torch.from_numpy(values),
                                               knms.grid_decode_tables(s, (480, 480)), 0.5, 0.3,
                                               cap)
    jb, jm = jax.vmap(lambda v: xla_decode_filter_nms(v, s, (480, 480), 0.5, 0.3, cap))(
        jnp.asarray(values.reshape(3, s, s, 5)))
    assert_same_rows(boxes, mask, jb, jm)


class OpOnly(torch.nn.Module):
    def __init__(self, s):
        super().__init__()
        for name, col in zip(("sx", "ox", "sy", "oy"), knms.grid_decode_tables(s, (320, 320))):
            self.register_buffer(name, torch.from_numpy(col))

    def forward(self, values):
        return torch.ops.fdtpu_torch.decode_filter_nms(values, self.sx, self.ox, self.sy,
                                                       self.oy, 320.0, 320.0, 0.5, 0.5, 16)


def test_export_of_the_op_alone_gives_one_node():
    ep = torch.export.export(OpOnly(5), (torch.zeros(2, 25, 5),), strict=False)
    assert op_nodes(ep.graph) == 1
    assert [n.op for n in ep.graph.nodes].count("call_function") == 3  # the op, two getitems
    values = torch.from_numpy(grid_values(3, 2, 5))
    for g, w in zip(ep.module()(values), OpOnly(5)(values)):
        assert torch.equal(g, w)


def test_fake_implementation_only_allocates():
    """Tracing never reaches the kernels' library: on fake tensors the op
    allocates outputs of the schema's shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        values = torch.empty(3, 100, 5)
        cols = [torch.empty(100) for _ in range(4)]
        boxes, mask = torch.ops.fdtpu_torch.decode_filter_nms(values, *cols, 1.0, 1.0, 0.5,
                                                              0.5, 7)
    assert boxes.shape == (3, 7, 5) and boxes.dtype == torch.float32
    assert mask.shape == (3, 7) and mask.dtype == torch.bool


def test_op_is_registered_with_the_dispatcher_for_cpu_and_cuda():
    """The op's kernels sit on the dispatcher's CPU and CUDA keys
    (``torch.library.Library``), with no Python layer of
    ``torch.library.custom_op`` in front of them on every call."""
    from torch._library.custom_ops import OPDEFS

    name = "fdtpu_torch::decode_filter_nms"
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), key
    assert name not in OPDEFS
    assert knms.decode_filter_nms_op is OP


def test_wrapper_calls_the_op_where_a_tracer_sees_it():
    """Plain eager calls go straight to the op's implementation; fake
    tensors, a function mode or a dispatch mode take the op, so an export
    records it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    values = torch.zeros(1, 4, 5)
    assert not knms._traced(values)
    with torch.device("cpu"):
        assert knms._traced(values)
    with Passthrough():
        assert knms._traced(values)
    with FakeTensorMode() as mode:
        assert knms._traced(mode.from_tensor(values))


def test_wrapper_counts_no_launch_on_the_cpu_and_rejects_other_devices():
    before = LAUNCHES.copy()
    knms.decode_filter_nms_batch(torch.zeros(1, 4, 5), knms.grid_decode_tables(2, (64, 64)),
                                 0.5, 0.5, 4)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        knms.decode_filter_nms_batch(torch.zeros(1, 4, 5, device="meta"),
                                     knms.grid_decode_tables(2, (64, 64)), 0.5, 0.5, 4)


# -- the predict program, port against fdtpu -------------------------------------------


def frames(b, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3)).astype(np.float32)


def boosted_poolresnet(seed=0, filters=16, size=96, s=3, kernel=3):
    """fdtpu PoolResnet params with the head's score and size columns
    scaled (as ``tests/test_native_infer.py`` boosts them) and its score
    bias shifted so that half the cells of a seeded frame pass ``PROB``:
    untrained weights then give a few well-separated detections. Returns
    fdtpu's module, its variables and the port's PoolResnet with the same
    weights."""
    jm = JaxPoolResnet(filters=filters, input_shape=(size, size), num_patches=s,
                       num_residual_blocks=2, output_kernel_size=kernel, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    head = params["Conv_1"]
    head["kernel"] = head["kernel"].copy()
    head["kernel"][..., 0] *= 5.0
    head["kernel"][..., 3:5] *= 5.0 / 3.0
    head["bias"] = head["bias"] + np.float32([0.3, 0, 0, 0.3, 0.3])
    tm = PoolResnet(filters, (size, size), s, 2, output_kernel_size=kernel)
    tm.load_state_dict(poolresnet_state_dict(params))
    with torch.no_grad():
        score = tm(torch.from_numpy(frames(1, size, seed=99)) / 255.0)[..., 0].double()
    shift = np.log(PROB / (1 - PROB)) - float(torch.logit(score).median())
    head["bias"] = head["bias"] + np.float32([shift, 0, 0, 0, 0])
    tm.load_state_dict(poolresnet_state_dict(params))
    return jm, {"params": params}, tm


def spread_ssd(seed=0):
    jm = JaxSSD(filters=4, input_shape=(64, 64), patch_sizes=(8, 4, 2, 1), dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    for i in range(4):
        d = params[f"Dense_{i}"]
        d["kernel"] = d["kernel"].copy()
        d["kernel"][:, 0] *= 4.0
    tm = SSD(4, (64, 64), (8, 4, 2, 1))
    tm.load_state_dict(ssd_state_dict(params))
    return jm, {"params": params}, tm


def pair(kind):
    if kind == "poolresnet":
        return boosted_poolresnet(seed=1)
    if kind == "ssd":
        return spread_ssd(seed=2)
    jm, v, tm = boosted_poolresnet(seed=3)
    return (JaxReferenceLayoutGrid(jm), {"params": {"inner": v["params"]}},
            ReferenceLayoutGrid(tm))


@pytest.mark.parametrize("kind", ["poolresnet", "ssd", "reference_layout"])
def test_exported_predict_matches_fdtpu(kind, tmp_path):
    """Exported first, on an empty table cache: the eager program after it
    still gets real tensors (the caches skip the trace's fake ones)."""
    knms.ssd_output_tables_on.cache_clear()
    from fdtpu_torch.core.priors import priors_on

    priors_on.cache_clear()
    jm, variables, tm = pair(kind)
    size = tm.input_shape[0]
    jpath = jax_export_predict(jm, variables, tmp_path / "m.stablehlo", batch_size=2,
                               probability_threshold=PROB, iou_threshold=IOU, capacity=CAP)
    tpath = export_predict(tm, tmp_path / "m.pt2", batch_size=2, probability_threshold=PROB,
                           iou_threshold=IOU, capacity=CAP, dtype=torch.float32)
    loaded = load_exported(tpath)
    assert op_nodes(loaded.graph) == 1
    x = frames(2, size, seed=5)
    boxes, mask = loaded(torch.from_numpy(x))
    jb, jmask = jax_load_exported(jpath)(jnp.asarray(x))
    assert_same_rows(boxes, mask, jb, jmask)
    assert 0 < int(mask.sum()) < CAP * 2, "the boosted heads give some detections"
    # the loaded program is the eager one, bit for bit
    program = PredictProgram(tm, PROB, IOU, CAP, torch.float32)
    with torch.no_grad():
        want = program(torch.from_numpy(x))
    assert torch.equal(boxes, want[0]) and torch.equal(mask, want[1])


def test_bf16_program_exports_and_matches_eager():
    _, _, tm = boosted_poolresnet(seed=4)
    program = PredictProgram(tm, PROB, IOU, CAP)  # bfloat16, the serving default
    ep = export_program(program, 2)
    assert op_nodes(ep.graph) == 1
    x = torch.from_numpy(frames(2, 96, seed=6))
    with torch.no_grad():
        want = program(x)
    for g, w in zip(ep.module()(x), want):
        assert torch.equal(g, w)


def test_aot_compile_on_the_cpu_is_the_exported_module():
    _, _, tm = boosted_poolresnet(seed=5)
    compiled = aot_compile_predict(tm, 2, PROB, IOU, CAP, device="cpu", dtype=torch.float32)
    assert op_nodes(compiled.graph) == 1
    x = torch.from_numpy(frames(2, 96, seed=7))
    with torch.no_grad():
        want = PredictProgram(tm, PROB, IOU, CAP, torch.float32)(x)
    for g, w in zip(compiled(x), want):
        assert torch.equal(g, w)


def test_graph_predict_needs_a_card():
    """A CUDA graph is captured on a card only: no CPU fallback."""
    from fdtpu_torch.export import GraphPredict

    _, _, tm = boosted_poolresnet(seed=5)
    program = PredictProgram(tm, PROB, IOU, CAP, torch.float32)
    with pytest.raises(ValueError, match="needs a card"):
        GraphPredict(program, torch.zeros(1, 96, 96, 3))


def test_aot_compile_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, _, tm = boosted_poolresnet(seed=5)
    with pytest.raises((RuntimeError, AssertionError)):
        aot_compile_predict(tm, 1, PROB, IOU, CAP)


LOAD_ALONE = """
import sys
import torch
from fdtpu_torch.export import load_exported
program = load_exported(sys.argv[1])
boxes, mask = program(torch.full((2, 96, 96, 3), 128.0))
assert boxes.shape == (2, 128, 5) and mask.shape == (2, 128)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "fdtpu"))
assert not bad, bad
assert "fdtpu_torch.kernels.build" not in sys.modules  # the CPU op builds nothing
print("ok")
"""


def test_pt2_loads_without_jax(tmp_path):
    _, _, tm = boosted_poolresnet(seed=6)
    path = export_predict(tm, tmp_path / "m.pt2", 2, PROB, IOU, CAP, dtype=torch.float32)
    proc = subprocess.run([sys.executable, "-c", LOAD_ALONE, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_convert_and_demo_entry_points(tmp_path):
    """``convert_checkpoint_to_exported_model`` from a checkpoint of the
    port, then ``demo_model_exported`` over two images: its counts are the
    eager program's."""
    from PIL import Image

    from fdtpu_torch import convert_checkpoint_to_exported_model, demo_model_exported
    from fdtpu_torch.demo_model_exported import resized

    _, _, tm = boosted_poolresnet(seed=7, size=160, s=5, kernel=6)  # the entry point's head
    ckpt = tmp_path / "step.pt"
    torch.save({"step": 0, "module": tm.state_dict()}, ckpt)
    images = tmp_path / "imgs"
    images.mkdir()
    for i in range(2):
        Image.fromarray(frames(1, 120, seed=10 + i)[0].astype(np.uint8)).save(images / f"{i}.jpg")
    out = tmp_path / "m.pt2"
    convert_checkpoint_to_exported_model.main([
        "--checkpoint", str(ckpt), "--out", str(out), "--input", "160", "--patches", "5",
        "--filters", "16", "--blocks", "2", "--prob-threshold", str(PROB),
        "--iou-threshold", str(IOU), "--capacity", str(CAP), "--dtype", "float32",
        "--device", "cpu"])
    counts = demo_model_exported.main(["--artifact", str(out), "--images", str(images),
                                       "--out", str(tmp_path / "ann"), "--input", "160",
                                       "--device", "cpu"])
    program = PredictProgram(tm, PROB, IOU, CAP, torch.float32)
    want = []
    for i in range(2):
        img = resized(images / f"{i}.jpg", 160, 160).astype(np.float32)
        with torch.no_grad():
            want.append(int(program(torch.from_numpy(img[None]))[1].sum()))
    assert counts == want and sum(counts) > 0
    assert len(list((tmp_path / "ann").glob("*.png"))) == 2
