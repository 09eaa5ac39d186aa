"""The port's WIDERFace loader against fdtpu's: the synthetic dataset, the
annotation parser, the data source (PIL decode, host rotation, the
degenerate-box and decode-failure fallbacks), the batch loader and the
prefetcher on the CPU. All of it is the same numpy and PIL code, so every
comparison is exact: bytes, arrays and floats equal."""

import filecmp

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.data import parse_wider_annotations as jax_parse
from fdtpu_torch.data import (
    BatchLoader,
    DevicePrefetcher,
    WIDERFaceDataSource,
    load_targets,
    make_synthetic_widerface,
    parse_wider_annotations,
)

SHAPE = (160, 160)
N_IMAGES = 8


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic dataset written by each package."""
    port = make_synthetic_widerface(tmp_path_factory.mktemp("port"), N_IMAGES, max_faces=3,
                                    seed=3)
    ref = jax_make_synthetic(tmp_path_factory.mktemp("fdtpu"), N_IMAGES, max_faces=3, seed=3)
    return port, ref


def test_synthetic_dataset_is_byte_identical(roots):
    port, ref = roots
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert len(files) == N_IMAGES + 1
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    for rel in files:
        assert filecmp.cmp(port / rel, ref / rel, shallow=False), rel


@pytest.mark.parametrize("max_faces", [2, 3, 10**9])
def test_targets_equal(roots, max_faces):
    port, ref = roots
    got, want = load_targets(port, "train", max_faces), jax_load_targets(ref, "train", max_faces)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["img_path"].relative_to(port) == w["img_path"].relative_to(ref)
        assert g["number_faces"] == w["number_faces"]
        np.testing.assert_array_equal(g["bbx"], w["bbx"])
        assert g["bbx"].dtype == w["bbx"].dtype == np.float32
    assert len(parse_wider_annotations(port)) == len(jax_parse(ref)) == N_IMAGES


def sources(roots, tmp_path, rotate_prob, **kw):
    """Each package's source over its copy of the dataset, with a degenerate
    target (an all-zero box: falls back to the previous index) at 2 and an
    unreadable image (logged, neighbor substituted) at 5."""
    made = []
    for root, cls, extra in ((roots[0], WIDERFaceDataSource, {"use_native": False}),
                             (roots[1], JaxSource, {"use_native": False})):
        targets = load_targets(root, "train", 10**9)
        targets[2] = dict(targets[2], bbx=np.concatenate(
            [targets[2]["bbx"], np.float32([[1, 0, 0, 0, 0]])]))
        targets[5] = dict(targets[5], img_path=root / "missing.jpg")
        log = tmp_path / f"{cls.__name__}_{len(made)}.log"
        made.append(cls(targets, SHAPE, box_capacity=4, error_log=str(log),
                        rotate_prob=rotate_prob, seed=7, **kw, **extra))
    return made


@pytest.mark.parametrize("rotate_prob", [0.0, 0.2])
def test_source_get_is_byte_equal(roots, tmp_path, rotate_prob):
    port, ref = sources(roots, tmp_path, rotate_prob)
    for _ in range(2):  # the second pass reads the decoded-frame cache
        for i in range(N_IMAGES):
            for g, w in zip(port.get(i), ref.get(i)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.get(2)[1], ref.get(1)[1])  # degenerate fallback
    logs = [open(s.error_log).read() for s in (port, ref)]
    assert logs[0].count("missing.jpg") == logs[1].count("missing.jpg") > 0


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, seed=4), dict(shuffle=True, drop_last=True),
    dict(epoch_fraction=4), dict(shuffle=True, epoch_fraction=4, seed=1)])
def test_batch_loader_batches_equal(roots, tmp_path, kw):
    """Batch by batch over two epochs, with the padded tail (3 of 8 at
    batch 3) and its ``sample_mask``."""
    src, jsrc = sources(roots, tmp_path, 0.2)
    loader, jloader = BatchLoader(src, 3, **kw), JaxBatchLoader(jsrc, 3, **kw)
    assert len(loader) == len(jloader)
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            for f in ("images", "boxes", "box_mask", "sample_mask"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
        if not kw.get("drop_last") and kw.get("epoch_fraction", 1) == 1:
            assert got[-1].sample_mask.tolist() == [True, True, False]


def test_prefetcher_on_cpu_yields_the_same_tensors(roots, tmp_path):
    src, _ = sources(roots, tmp_path, 0.0)
    loader = BatchLoader(src, 3)
    want = list(loader)
    got = list(DevicePrefetcher(loader, torch.device("cpu")))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in ("images", "boxes", "box_mask", "sample_mask"):
            t = getattr(g, f)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), getattr(w, f))
