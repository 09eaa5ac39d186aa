"""The port's ``.fdn`` writer and its copy of the C++ engine, against fdtpu.

The writer's bytes equal fdtpu's ``export_native`` for the same weights
(fdtpu's params converted with ``compat/from_fdtpu.py``, exact in float32)
for every family, the reference-layout wrap and int8. The port's engine
serves the port's model as the port's float32 predict does, within the
tolerance of ``tests/test_native_infer.py`` (atol 2e-3, rtol 1e-4 on the
kept rows, counts equal); the numpy interpreter follows the engine op by
op; the CLI serves a JPEG; the loader decodes as PIL does, roughly, and
builds against the compiler's libjpeg (with an rpath to it) or against the
libjpeg-turbo of Pillow's wheel, with the same bytes. The data source at its
default decoder (the loader, where it loads) equals fdtpu's bit for bit:
``get``, ``get_batch`` with its neighbour substitution, and the
``BatchLoader``'s batches.
"""

import copy
import functools
import io
import json
import struct
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.compat.torch_import import ReferenceLayoutGrid as JaxReferenceLayoutGrid
from fdtpu.export import export_native as jax_export_native
from fdtpu.models import SSD as JaxSSD
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.models import Resnet as JaxResnet
from fdtpu.models import SeparableCNN as JaxSeparableCNN
from fdtpu_torch.compat import ReferenceLayoutGrid, state_dict_from_fdtpu
from fdtpu_torch.core import compact_boxes
from fdtpu_torch.export import export_native
from fdtpu_torch.models import (
    SSD,
    Detector,
    MobileNetV3Backbone,
    PoolResnet,
    Resnet,
    SeparableCNN,
)
from fdtpu_torch.native import NativeDetector, build_cli
from fdtpu_torch.native.reference_interp import trace

PROB, IOU, CAP = 0.45, 0.3, 64
ATOL, RTOL = 2e-3, 1e-4  # tests/test_native_infer.py's _assert_parity


def boosted(params, scale, bias):
    """The grid head's score and size columns scaled and biased, so that
    untrained weights give well-separated detections
    (``tests/test_native_infer.py``'s ``_boosted_init``)."""
    head = params["Conv_1"]
    head["kernel"] = head["kernel"].copy()
    head["kernel"][..., 0] *= scale
    head["kernel"][..., 3:5] *= scale / 3.0
    head["bias"] = head["bias"] + np.float32([bias, 0, 0, 0.3, 0.3])


def randomized_mobilenetv3(params, stats, seed=7):
    """BatchNorm statistics and affines drawn at random (numpy), so that
    the fold is not the identity, and the head's bias raised."""
    rng = np.random.default_rng(seed)
    stats = jtu.tree_map(lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), stats)

    def bn(path, x):
        name = jtu.keystr(path)
        if "bn" in name and ("scale" in name or "bias" in name):
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    params = jtu.tree_map_with_path(bn, params)
    params["head"]["bias"] = params["head"]["bias"] + np.float32([0.5, 0, 0, 0.3, 0.3])
    return params, stats


@functools.lru_cache(maxsize=None)
def initial_variables(jm, seed):
    """fdtpu's init of ``jm`` as numpy trees, once per module and seed
    (MobileNetV3's init takes ~25 s on the CPU); callers copy before
    changing them."""
    size = jm.input_shape[0]
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False)
    return jax.tree.map(np.asarray, dict(v))


def family(kind, seed=0):
    """``(fdtpu module, its variables, the port's module with the same
    weights, its input size)`` for one kind of artifact."""
    if kind in ("poolresnet", "int8", "reference_layout"):
        filters = 24 if kind == "int8" else 32  # 24: the int8 GEMM's edge path
        jm = JaxPoolResnet(filters=filters, input_shape=(160, 160), num_patches=3,
                           num_residual_blocks=2, output_kernel_size=3, dtype=jnp.float32)
        tm = PoolResnet(filters, (160, 160), 3, 2, output_kernel_size=3)
        scale, bias = (5.0, 12.0) if kind == "int8" else (5.0, 0.3)
    elif kind == "resnet":
        jm = JaxResnet(filters=32, input_shape=(96, 96), num_patches=6, num_residual_blocks=2,
                       dtype=jnp.float32)
        tm = Resnet(32, (96, 96), 6, 2)
        scale, bias = 5.0, 0.3
    elif kind == "separable":
        jm = JaxSeparableCNN(filters=32, input_shape=(128, 128), num_patches=8,
                             num_residual_blocks=2, dtype=jnp.float32)
        tm = SeparableCNN(32, (128, 128), 8, 2)
        scale, bias = 2.0, 0.0
    elif kind == "mobilenetv3":
        jm = JaxMobileNetV3(input_shape=(96, 96), num_patches=3, dtype=jnp.float32)
        tm = MobileNetV3Backbone((96, 96), 3)
    elif kind == "ssd":
        jm = JaxSSD(filters=4, input_shape=(64, 64), patch_sizes=(8, 4, 2, 1), dtype=jnp.float32)
        tm = SSD(4, (64, 64), (8, 4, 2, 1))
    else:
        raise ValueError(kind)
    size = jm.input_shape[0]
    v = copy.deepcopy(initial_variables(jm, seed))
    params = v["params"]
    stats = None
    if kind == "mobilenetv3":
        params, stats = randomized_mobilenetv3(params, v["batch_stats"])
    elif kind == "ssd":
        for i in range(4):  # spread the scores: the pick order is not f32 noise
            params[f"Dense_{i}"]["kernel"] = params[f"Dense_{i}"]["kernel"].copy()
            params[f"Dense_{i}"]["kernel"][:, 0] *= 4.0
    else:
        boosted(params, scale, bias)
    tm.load_state_dict(state_dict_from_fdtpu(params, tm, stats))
    variables = {"params": params} if stats is None else {"params": params, "batch_stats": stats}
    if kind == "reference_layout":
        return (JaxReferenceLayoutGrid(jm), {"params": {"inner": params}},
                ReferenceLayoutGrid(tm), size)
    return jm, variables, tm.eval(), size


def images(n, size, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


KINDS = ["poolresnet", "resnet", "separable", "mobilenetv3", "ssd", "reference_layout", "int8"]


@pytest.mark.parametrize("kind", KINDS)
def test_fdn_bytes_equal_fdtpu(kind, tmp_path):
    jm, variables, tm, _ = family(kind)
    quant = "int8" if kind == "int8" else None
    want = jax_export_native(jm, variables, tmp_path / "fdtpu.fdn", PROB, IOU, CAP,
                             weight_quant=quant).read_bytes()
    got = export_native(tm, tmp_path / "port.fdn", PROB, IOU, CAP,
                        weight_quant=quant).read_bytes()
    assert got == want


def test_ssd_int8_bytes_equal_fdtpu(tmp_path):
    """The SSD with int8 weights: its ``PUSH_PROJ`` convs stay float32."""
    jm, variables, tm, _ = family("ssd", seed=1)
    want = jax_export_native(jm, variables, tmp_path / "fdtpu.fdn", weight_quant="int8")
    got = export_native(tm, tmp_path / "port.fdn", weight_quant="int8")
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("kind", ["poolresnet", "resnet", "separable", "ssd", "reference_layout",
                                  "mobilenetv3"])
def test_engine_matches_the_ports_predict(kind, tmp_path):
    """The engine on the port's artifact against the port's float32 forward
    and K1's decode on the CPU. MobileNetV3's untrained cells score within
    ~1e-5 of each other, so there the IoU threshold suppresses nothing and
    the rows are compared sorted by position (as fdtpu's test does)."""
    _, _, tm, size = family(kind, seed=2)
    iou = 0.999 if kind == "mobilenetv3" else IOU
    path = export_native(tm, tmp_path / "m.fdn", PROB, iou, CAP)
    imgs = images(2, size, seed=3)
    nb, nm = NativeDetector(path).predict(imgs)
    det = Detector(tm, PROB, iou, CAP, dtype=torch.float32)
    tb, tmask = det.non_max_suppression(det.apply(torch.from_numpy(imgs) / 255.0))
    total = 0
    for i in range(len(imgs)):
        got, want = nb[i][nm[i]], compact_boxes(tb[i], tmask[i])
        assert len(got) == len(want), (i, got, want)
        if kind == "mobilenetv3":
            got, want = (a[np.lexsort((a[:, 1], a[:, 2]))] for a in (got, want))
        if len(got):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        total += len(got)
    assert total > 0


@pytest.mark.parametrize("kind", ["int8", "ssd", "mobilenetv3"])
def test_engine_copy_equals_fdtpus_engine(kind, tmp_path):
    """The port's engine (its own copy of the source, built on its own) on
    the port's artifact gives fdtpu's engine's outputs on fdtpu's artifact,
    bit for bit."""
    from fdtpu.native.infer import NativeDetector as JaxNativeDetector

    jm, variables, tm, size = family(kind, seed=4)
    quant = "int8" if kind in ("int8", "ssd") else None
    path = export_native(tm, tmp_path / "port.fdn", PROB, IOU, CAP, weight_quant=quant)
    jpath = jax_export_native(jm, variables, tmp_path / "fdtpu.fdn", PROB, IOU, CAP,
                              weight_quant=quant)
    imgs = images(2, size, seed=5)
    for got, want in zip(NativeDetector(path).predict(imgs),
                         JaxNativeDetector(jpath).predict(imgs)):
        np.testing.assert_array_equal(got, want)


def test_engine_int8_keeps_the_float32_detections(tmp_path):
    """int8 weights: about 4x smaller, and every float32 box has an int8
    match at IoU > 0.5 with its score within 0.1 (``test_native_infer``)."""
    _, _, tm, size = family("int8")
    pf = export_native(tm, tmp_path / "f32.fdn", PROB, IOU, CAP)
    pq = export_native(tm, tmp_path / "q8.fdn", PROB, IOU, CAP, weight_quant="int8")
    assert pq.stat().st_size < pf.stat().st_size / 2.5
    imgs = images(2, size)
    bf, mf = NativeDetector(pf).predict(imgs)
    bq, mq = NativeDetector(pq).predict(imgs)

    def iou(a, b):
        ix = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
        iy = max(0.0, min(a[2] + a[4], b[2] + b[4]) - max(a[2], b[2]))
        union = a[3] * a[4] + b[3] * b[4] - ix * iy
        return ix * iy / union if union > 0 else 0.0

    total = 0
    for i in range(len(imgs)):
        for a in bf[i][mf[i]]:
            best = max((iou(a, b), b[0]) for b in bq[i][mq[i]])
            assert best[0] > 0.5 and abs(best[1] - a[0]) < 0.1, (a, best)
            total += 1
    assert total > 0


def dumped(dump_dir, acts, atol_of_scale):
    """Compare the engine's ``FDN_DEBUG_DIR`` per-op dumps with the
    interpreter's activations; the number compared."""
    compared = 0
    for oi, act in enumerate(acts):
        f = dump_dir / f"op{oi:03d}.bin"
        if act is None or not f.exists():
            continue
        raw = f.read_bytes()
        h, w, c = struct.unpack_from("<3i", raw)
        got = np.frombuffer(raw, np.float32, offset=12).reshape(h, w, c)
        assert got.shape == act.shape, (oi, got.shape, act.shape)
        scale = max(1.0, float(np.abs(act).max()))
        np.testing.assert_allclose(got, act, atol=atol_of_scale * scale, rtol=0,
                                   err_msg=f"op {oi}")
        compared += 1
    return compared


@pytest.mark.parametrize("kind", ["int8", "ssd"])
def test_reference_interp_follows_the_engine(kind, tmp_path, monkeypatch):
    """The numpy interpreter reproduces the engine's per-op activations on
    an int8 artifact: the grid model (its GEMM's edge path), and the SSD
    (``PUSH_PROJ`` and the heads' prior writes). The SSD's deep quantized
    stack lets one-ulp differences flip quantization codes, hence 1e-2 of
    the scale there (``test_native_infer``'s bound)."""
    _, _, tm, size = family(kind, seed=1)
    path = export_native(tm, tmp_path / "d.fdn", PROB, IOU, CAP, weight_quant="int8")
    img = images(1, size)[0]
    dump = tmp_path / "dumps"
    dump.mkdir()
    monkeypatch.setenv("FDN_DEBUG_DIR", str(dump))
    NativeDetector(path).predict(img[None], num_threads=1)
    ops, acts, ssd = trace(path, img, quantized=True)
    compared = dumped(dump, acts, 2e-3 if kind == "int8" else 1e-2)
    if kind == "ssd":
        assert any(op[0] == 14 for op in ops) and ssd
        assert compared > sum(op[0] == 6 for op in ops) >= 4
    else:
        assert compared >= 8


def test_engine_rejects_a_corrupt_artifact(tmp_path):
    _, _, tm, _ = family("poolresnet")
    path = export_native(tm, tmp_path / "ok.fdn", PROB, IOU, CAP)
    NativeDetector(path)
    raw = bytearray(path.read_bytes())
    trunc = tmp_path / "trunc.fdn"
    trunc.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError):
        NativeDetector(trunc)
    raw[76:84] = (1 << 40).to_bytes(8, "little")  # the first op's weight offset
    bad = tmp_path / "badoff.fdn"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        NativeDetector(bad)


def test_cli_serves_a_jpeg(tmp_path):
    """``fdn_serve``: a JPEG in, JSON boxes out, no Python in the process."""
    from PIL import Image

    _, _, tm, size = family("poolresnet", seed=1)
    path = export_native(tm, tmp_path / "cli.fdn", PROB, IOU, CAP)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(images(1, size, seed=1)[0].astype(np.uint8)).save(jpg, quality=95)
    out = subprocess.run([str(build_cli()), str(path), str(jpg)], capture_output=True, text=True,
                         timeout=120, check=True)
    rec = json.loads(out.stdout.strip())
    assert rec["file"] == str(jpg) and isinstance(rec["boxes"], list)
    for row in rec["boxes"]:
        assert len(row) == 5 and row[0] > PROB


def test_build_is_named_by_its_sources_and_raises_when_gxx_fails(tmp_path, monkeypatch):
    from fdtpu_torch.native import build as nbuild

    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    first = nbuild.output_path("libx", (src,), ("-shared",))
    assert first.parent == nbuild.BUILD_DIR
    src.write_text("int f() { return 2; }\n")
    assert nbuild.output_path("libx", (src,), ("-shared",)) != first
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g.. failed"):
        nbuild.gxx_build("libx", (src,), ("-shared", "-fPIC"), ".so")
    assert not list((tmp_path / "build").glob("libx*"))  # nothing half-written left


def test_native_entry_points(tmp_path):
    """``convert_checkpoint_to_native_model`` (int8, with its warning) from a
    checkpoint of the port, then ``demo_model_native``: its counts are the
    engine's."""
    from PIL import Image

    from fdtpu_torch import convert_checkpoint_to_native_model, demo_model_native
    from fdtpu_torch.demo_model_exported import resized

    tm = PoolResnet(16, (160, 160), 5, 2, generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "step.pt"
    torch.save({"step": 0, "module": tm.state_dict()}, ckpt)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        Image.fromarray(images(1, 200, seed=i)[0].astype(np.uint8)).save(imgs / f"{i}.jpg")
    out = tmp_path / "m.fdn"
    with pytest.warns(UserWarning, match="int8 weights change the detections"):
        convert_checkpoint_to_native_model.main([
            "--checkpoint", str(ckpt), "--out", str(out), "--input", "160", "--patches", "5",
            "--filters", "16", "--blocks", "2", "--prob-threshold", "0.3", "--quantize", "int8",
            "--device", "cpu"])
    assert out.read_bytes() == export_native(tm, tmp_path / "w.fdn", 0.3, 0.01,
                                             weight_quant="int8").read_bytes()
    counts = demo_model_native.main(["--artifact", str(out), "--images", str(imgs),
                                     "--out", str(tmp_path / "ann")])
    engine = NativeDetector(out)
    want = [int(engine.predict(resized(imgs / f"{i}.jpg", 160, 160))[1].sum()) for i in range(2)]
    assert counts == want


# -- the loader ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("jpgs")
    paths = []
    for i, (w, h) in enumerate([(300, 200), (641, 480)]):
        p = d / f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(p, quality=92)
        paths.append(p)
    gray = d / "gray.jpg"
    Image.fromarray(rng.integers(0, 255, size=(200, 300), dtype=np.uint8), mode="L").save(gray)
    return paths + [gray]


def test_loader_decodes_as_pil_roughly_and_as_fdtpu(jpegs):
    """The port's loader builds here, decodes as fdtpu's copy does (the same
    source), and agrees with PIL's antialiased resize structurally."""
    from PIL import Image

    from fdtpu.native import decode_resize as fdtpu_decode_resize
    from fdtpu_torch.native import decode_resize, native_available

    assert native_available()
    got, dims = decode_resize(jpegs[0].read_bytes(), 160, 160)
    assert got.shape == (160, 160, 3) and got.dtype == np.uint8 and dims == (300, 200)
    want, _ = fdtpu_decode_resize(jpegs[0].read_bytes(), 160, 160)
    np.testing.assert_array_equal(got, want)
    pil = np.asarray(Image.open(jpegs[0]).convert("RGB").resize((160, 160), Image.BILINEAR))
    assert np.abs(got.astype(int) - pil.astype(int)).mean() < 20
    gray, _ = decode_resize(jpegs[-1].read_bytes(), 100, 100)
    assert (gray[..., 0] == gray[..., 1]).all()
    with pytest.raises(ValueError):
        decode_resize(b"definitely not a jpeg", 64, 64)


def test_loader_batch_decode(jpegs):
    from fdtpu_torch.native import decode_resize, decode_resize_batch

    blobs = [p.read_bytes() for p in jpegs] + [b"broken"]
    imgs, dims, fails = decode_resize_batch(blobs, 128, 128, num_threads=2)
    assert imgs.shape == (len(blobs), 128, 128, 3) and fails == 1
    assert tuple(dims[-1]) == (-1, -1) and tuple(dims[1]) == (641, 480)
    assert (imgs[-1] == 0).all()
    np.testing.assert_array_equal(imgs[1], decode_resize(blobs[1], 128, 128)[0])


def test_loader_is_unavailable_where_it_cannot_load(tmp_path, monkeypatch, jpegs):
    """A library that links but does not load (its libjpeg missing at run
    time) leaves the loader unavailable, and a decode through it raises."""
    from fdtpu_torch.native import loader

    broken = tmp_path / "libfastloader.so"
    broken.write_text("not a shared library")
    monkeypatch.setattr(loader, "build", lambda: broken)
    loader._load.cache_clear()
    try:
        assert not loader.native_available()
        with pytest.raises(RuntimeError, match="could not be built"):
            loader.decode_resize(jpegs[0].read_bytes(), 64, 64)
    finally:
        loader._load.cache_clear()


def test_loader_builds_against_pillows_libjpeg_alike():
    """Where the compiler has no libjpeg of its own, the loader links the
    libjpeg-turbo of Pillow's wheel through the headers in
    ``native/include``: here both routes build, and decode the same bytes."""
    from PIL import Image

    from fdtpu_torch.native import loader
    from fdtpu_torch.native.build import gxx_build

    bundled = loader.bundled_libjpeg()
    assert bundled is not None and f"-I{loader.INCLUDE}" in bundled
    lib = Path(bundled[1])
    assert lib.parent.name == "pillow.libs" and ".so.62" in lib.name
    assert bundled[2] == f"-Wl,-rpath,{lib.parent}"
    path = gxx_build("libfastloader", (loader.LOADER,), (*loader.LINK, *bundled), ".so",
                     deps=loader.HEADERS)
    assert path != loader.build()
    needed = subprocess.run(["readelf", "-d", str(path)], capture_output=True, text=True).stdout
    assert lib.name in needed and str(lib.parent) in needed  # NEEDED, and its RUNPATH
    rng = np.random.default_rng(3)
    blobs = []
    for w, h in ((1024, 768), (300, 200), (97, 61)):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG",
                                                                              quality=90)
        blobs.append(buf.getvalue())
    blobs.append(b"not a jpeg")
    loader._load.cache_clear()
    try:
        want = loader.decode_resize_batch(blobs, 320, 320)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(loader, "build", lambda: path)
            loader._load.cache_clear()
            got = loader.decode_resize_batch(blobs, 320, 320)
    finally:
        loader._load.cache_clear()
    assert got[2] == want[2] == 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_system_libjpeg_is_linked_with_an_rpath_to_its_directory():
    """The compiler's own libjpeg comes with an rpath to the directory the
    linker took it from, so that the dynamic loader finds the same file."""
    from fdtpu_torch.native import loader

    found = subprocess.run(["g++", "-print-file-name=libjpeg.so"], capture_output=True,
                           text=True).stdout.strip()
    assert Path(found).is_absolute()
    rpath = f"-Wl,-rpath,{Path(found).resolve().parent}"
    assert loader.system_libjpeg() == ("-ljpeg", rpath)
    dynamic = subprocess.run(["readelf", "-d", str(loader.build())], capture_output=True,
                             text=True).stdout
    assert "libjpeg.so.62" in dynamic and str(Path(found).resolve().parent) in dynamic


def test_build_falls_through_to_pillows_libjpeg_where_a_build_does_not_load(tmp_path,
                                                                          monkeypatch):
    """A library that links against the compiler's libjpeg but does not
    load (a stale copy, a libjpeg the loader cannot find) gives way to the
    build against Pillow's; where none loads, the build raises."""
    from fdtpu_torch.native import build as nbuild
    from fdtpu_torch.native import loader

    real, broken = nbuild.gxx_build, tmp_path / "libfastloader.so"
    broken.write_text("not a shared library")
    monkeypatch.setattr(nbuild, "gxx_build", lambda stem, sources, args, suffix="", deps=():
                        broken if "-ljpeg" in args else real(stem, sources, args, suffix, deps))
    path = loader.build()
    needed = subprocess.run(["readelf", "-d", str(path)], capture_output=True, text=True).stdout
    assert path != broken and Path(loader.bundled_libjpeg()[1]).name in needed
    monkeypatch.setattr(loader, "bundled_libjpeg", lambda: None)
    with pytest.raises(RuntimeError, match="links and loads with no libjpeg"):
        loader.build()


def test_build_digest_covers_the_headers(tmp_path):
    from fdtpu_torch.native import build as nbuild

    src, header = tmp_path / "x.cpp", tmp_path / "x.h"
    src.write_text("int f() { return 1; }\n")
    header.write_text("#define X 1\n")
    first = nbuild.output_path("libx", (src,), ("-shared",), deps=(header,))
    header.write_text("#define X 2\n")
    assert nbuild.output_path("libx", (src,), ("-shared",), deps=(header,)) != first
    assert nbuild.output_path("libx", (src,), ("-shared",)) != first


# -- the native feed -------------------------------------------------------------------------


def native_sources(tmp_path, n=6, **kw):
    """fdtpu's source and the port's, each at its default decoder, over its
    own byte-identical copy of a synthetic dataset."""
    from fdtpu.data import WIDERFaceDataSource as JaxSource
    from fdtpu.data import load_targets as jax_load_targets
    from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
    from fdtpu_torch.data import WIDERFaceDataSource, load_targets, make_synthetic_widerface

    jroot = jax_make_synthetic(tmp_path / "fdtpu", num_images=n, max_faces=2)
    root = make_synthetic_widerface(tmp_path / "port", num_images=n, max_faces=2)
    jt, t = jax_load_targets(jroot, "train", max_faces=3), load_targets(root, "train", max_faces=3)
    return (JaxSource(jt, (160, 160), box_capacity=4, error_log=None, **kw),
            WIDERFaceDataSource(t, (160, 160), box_capacity=4, error_log=None, **kw))


def test_source_decodes_natively_where_the_loader_builds(tmp_path):
    """``use_native=None`` is fdtpu's rule: the loader where it loads (here),
    and a JPEG then decodes through it, not through PIL."""
    from PIL import Image

    from fdtpu_torch.native import decode_resize, native_available

    jsrc, src = native_sources(tmp_path, n=2)
    assert native_available() and src.use_native is jsrc.use_native is True
    path = src.targets[0]["img_path"]
    img, dims = src._decode(path)
    want = decode_resize(Path(path).read_bytes(), 160, 160)
    np.testing.assert_array_equal(img, want[0])
    assert dims == want[1]
    _, plain = native_sources(tmp_path / "pil", n=2, use_native=False)
    pil = np.asarray(Image.open(path).convert("RGB").resize((160, 160), Image.BILINEAR))
    np.testing.assert_array_equal(plain._decode(path)[0], pil)
    assert not np.array_equal(img, pil)  # the two decoders differ


def test_native_source_equals_fdtpus(tmp_path):
    """``get`` and ``get_batch`` of the port's source equal fdtpu's bit for
    bit at the default decoder, misses and RAM-cache hits alike, with host
    rotation on (its draws follow the same order)."""
    jsrc, src = native_sources(tmp_path, rotate_prob=0.5, seed=3)
    for idx in ([0, 1, 2, 3], [4, 5, 0, 1], [5, 2, 4, 3]):  # misses first, then the cache
        for g, w in zip(src.get_batch(idx), jsrc.get_batch(idx)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    for i in range(len(src)):
        for a, b in zip(src.get(i), jsrc.get(i)):
            np.testing.assert_array_equal(a, b)
    _, fresh = native_sources(tmp_path / "fresh", cache_decoded=False)
    for g, w in zip(fresh.get_batch(range(6)), [fresh.get(i) for i in range(6)]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_native_batch_loader_equals_fdtpus(tmp_path, monkeypatch):
    """The port's ``BatchLoader`` makes each batch through one threaded
    ``decode_resize_batch`` call, and its batches equal fdtpu's."""
    import fdtpu_torch.native as native_pkg
    from fdtpu.data import BatchLoader as JaxBatchLoader
    from fdtpu_torch.data import BatchLoader

    jsrc, src = native_sources(tmp_path)
    calls = []
    real = native_pkg.decode_resize_batch

    def spy(blobs, h, w, num_threads=0):
        calls.append(len(blobs))
        return real(blobs, h, w, num_threads)

    monkeypatch.setattr(native_pkg, "decode_resize_batch", spy)
    for _ in range(2):  # the second epoch reads the RAM cache
        got = list(BatchLoader(src, batch_size=4, shuffle=True, seed=1))
        want = list(JaxBatchLoader(jsrc, batch_size=4, shuffle=True, seed=1))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for field in ("images", "boxes", "box_mask", "sample_mask"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    assert calls == [4, 2]  # one native call a batch, none once cached


def test_get_batch_substitutes_a_neighbour_for_a_corrupt_jpeg(tmp_path):
    """fdtpu's ``tests/test_native.py`` case: a slot whose bytes are not a
    JPEG takes its neighbour's sample and is logged, as fdtpu's does."""
    jsrc, src = native_sources(tmp_path, n=4)
    for s, log in ((jsrc, "fdtpu.log"), (src, "port.log")):
        s.targets[2]["img_path"].write_bytes(b"not a jpeg at all")
        s.error_log = str(tmp_path / log)
    got, want = src.get_batch([0, 1, 2, 3]), jsrc.get_batch([0, 1, 2, 3])
    neighbour = src.get(1)
    for a, b, c in zip(got[2], want[2], neighbour):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
    assert (tmp_path / "port.log").read_text().split(",")[0] == "2"
    assert (tmp_path / "fdtpu.log").read_text().split(",")[0] == "2"
