"""The port's entry points on the CPU at 160 px, 16 filters, 2 blocks, b4,
on 8 synthetic train and 8 val images: ``train_model`` trains an epoch and
writes a checkpoint, which ``run_validation_epoch``, ``load_checkpoint`` and
``demo_model`` read (``run_validation_epoch`` given ``--model poolresnet``:
its default is fdtpu's, MobileNetV3); the zoo's other families and reference
TorchScript ``.pth`` checkpoints go through the same entry points;
``bench``'s measuring functions give ``bench.py``'s keys, and its FLOP count
equals ``bench.py``'s; the copy of the official WIDERFace evaluator equals
fdtpu's (exactly: the same numpy code)."""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fdtpu.train import widerface_eval as jwe
from fdtpu_torch import bench, demo_model, load_checkpoint, run_validation_epoch, train_model
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.train import widerface_eval as twe
from fdtpu_torch.models import PoolResnet
from fdtpu_torch.train.checkpoint import restore_variables
from test_torch_torch_import import (
    reference_grid_state_dict,
    reference_mobilenetv3_state_dict,
    save_archive,
)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--input", "160", "--patches", "5", "--filters", "16", "--blocks", "2",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``train_model`` in a scratch working directory; its
    checkpoint path and the data root."""
    work = tmp_path_factory.mktemp("work")
    make_synthetic_widerface(work / "data", 8, split="train", seed=0)
    make_synthetic_widerface(work / "data", 8, split="val", seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        ckpt = train_model.main(["--data-dir", "data", "--epochs", "1", "--batch-size", "4",
                                 *SMALL])
    return work, Path(ckpt)


def test_train_model_writes_a_checkpoint_and_logs(trained):
    work, ckpt = trained
    run = "poolresnet_16_5x5_160x160"
    assert ckpt == work / "checkpoints" / run / "step_00000002.pt"
    sd = restore_variables(ckpt)
    assert sd["conv1.weight"].shape == (16, 3, 10, 10)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in sd.values())
    lines = (work / "logs" / f"out_{run}.log").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["split=training", "split=validation"]


def test_run_validation_epoch_reads_the_checkpoint(trained, monkeypatch):
    work, ckpt = trained
    monkeypatch.chdir(work)
    args = ["--data-dir", "data", "--checkpoint", str(ckpt), "--batch-size", "4",
            "--model", "poolresnet", *SMALL]
    plain = run_validation_epoch.main(args)
    with_ap = run_validation_epoch.main([*args, "--with-ap"])
    assert set(plain) == {"loss", "iou", "precision", "recall", "f1"}
    for k in plain:  # one pass of the same eval step: the same means
        np.testing.assert_allclose(with_ap[k], plain[k], rtol=1e-6, err_msg=k)
    assert 0.0 <= with_ap["AP@0.5"] <= 1.0
    fresh = run_validation_epoch.main([a for a in args if a not in ("--checkpoint", str(ckpt))])
    assert fresh["loss"] != plain["loss"]  # the checkpoint was loaded


@pytest.mark.parametrize("extra,item", [(["--model", "resnet"], "item 4"),
                                        (["--checkpoint", "model.pth"], "item 4")])
def test_run_validation_epoch_unported_raise(extra, item, trained, tmp_path, monkeypatch):
    """What ROADMAP.md queue 1 ``item`` left out of this entry point runs
    now: another family (``--model resnet``) and a reference TorchScript
    checkpoint (``model.pth``, for MobileNetV3, the default family); a
    ``.pth`` that does not fit the model raises."""
    work, _ = trained
    monkeypatch.chdir(tmp_path)
    save_archive(reference_mobilenetv3_state_dict(), tmp_path / "model.pth")
    base = ["--data-dir", str(work / "data"), "--batch-size", "4", *SMALL]
    metrics = run_validation_epoch.main([*base, *extra])
    assert set(metrics) == {"loss", "iou", "precision", "recall", "f1"}
    assert all(np.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="does not fit PoolResnet"):
        run_validation_epoch.main([*base, "--model", "poolresnet", "--checkpoint", "model.pth"])


def test_load_checkpoint_and_demo_read_the_checkpoint(trained, monkeypatch):
    work, ckpt = trained
    monkeypatch.chdir(work)
    gt, pred = load_checkpoint.main(["--data-dir", "data", "--checkpoint", str(ckpt), *SMALL])
    assert gt.shape[1] == 5 and pred.ndim == 2 and pred.shape[1] == 5
    images = work / "data" / "WIDER_val" / "images" / "0--Synthetic"
    demo_model.main(["--images", str(images), "--out", "annotated", "--checkpoint", str(ckpt),
                     *SMALL])
    assert len(list((work / "annotated").glob("*.png"))) == 8
    # a reference TorchScript checkpoint of the same PoolResnet (ROADMAP.md
    # queue 1, item 4): served through ReferenceLayoutGrid
    save_archive(reference_grid_state_dict(PoolResnet(16, (160, 160), 5, 2)), work / "model.pth")
    demo_model.main(["--images", str(images), "--out", "annotated_pth", "--checkpoint",
                     "model.pth", *SMALL])
    assert len(list((work / "annotated_pth").glob("*.png"))) == 8


def test_train_model_unported_model_raises(tmp_path, monkeypatch):
    """``--model resnet`` (ROADMAP.md queue 1, item 4) trains now; a
    pretrained backbone is MobileNetV3's only, and with another family the
    entry point exits."""
    monkeypatch.chdir(tmp_path)
    make_synthetic_widerface(tmp_path / "data", 2, split="train")
    make_synthetic_widerface(tmp_path / "data", 2, split="val")
    ckpt = train_model.main(["--data-dir", "data", "--model", "resnet", "--epochs", "1",
                             "--batch-size", "2", *SMALL])
    assert Path(ckpt).parent.name == "resnet_16_5x5_160x160"
    with pytest.raises(SystemExit, match="mobilenetv3"):
        train_model.main(["--data-dir", "data", "--model", "resnet", "--pretrained-backbone",
                          "model.pth", *SMALL])


def load_reference_bench():
    spec = importlib.util.spec_from_file_location("reference_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # its top level imports json, time and numpy only
    return mod


def reference_bench_keys() -> set[str]:
    """Every key ``bench.py`` puts into its result line (the dict literal
    and the later ``result[...] =`` assignments)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_bench_gives_bench_py_keys():
    want = reference_bench_keys()
    assert {"metric", "value", "vs_baseline", "serving_latency_b1_ms", "train_mfu"} <= want
    r = bench.run("cpu", rotate_device=True, train_iters=2, infer_iters=2, latency_iters=2,
                  reps=2, size=160, batch=4, filters=16, blocks=2, grid=5)
    assert set(r) == want | {"card", "serving_latency_b1_ms_min_max", "rotate_device"}
    assert r["metric"] == "train_images_per_sec_per_chip_320px" and r["reps"] == 2
    assert r["device"] == "cpu" and r["card"] is None
    assert r["train_mfu"] is None and r["infer_mfu"] is None  # no card, no MFU
    for k in ("value", "infer_images_per_sec", "serving_latency_b1_ms"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    lo, hi = r["train_img_s_min_max"]
    assert lo <= r["value"] <= hi
    ref = load_reference_bench()
    assert (bench.TORCH_CPU_TRAIN_IMG_S, bench.TORCH_CPU_INFER_IMG_S) == (
        ref.TORCH_CPU_TRAIN_IMG_S, ref.TORCH_CPU_INFER_IMG_S)
    assert (bench.TRAIN_LOOP, bench.INFER_LOOP, bench.LATENCY_LOOP, bench.REPS) == (
        ref.TRAIN_SCAN, ref.INFER_SCAN, ref.LATENCY_SCAN, ref.REPS)
    assert bench.PEAK_BF16_FLOPS == 989e12


@pytest.mark.parametrize("size,filters,blocks,grid", [
    (320, 128, 10, 15), (480, 128, 10, 10), (160, 16, 2, 5), (640, 64, 6, 12), (256, 32, 0, 15)])
def test_forward_flops_equal_bench_py(size, filters, blocks, grid):
    ref = load_reference_bench()
    assert bench.poolresnet_forward_flops(size, filters, blocks, grid) == \
        ref.poolresnet_forward_flops(size, filters, blocks, grid)
    if (size, filters, blocks, grid) == (320, 128, 10, 15):
        assert bench.poolresnet_forward_flops(size, filters, blocks) == 3_200_332_800


def random_split(rng, n_images=12):
    """Predictions and ground truth with near misses, duplicates, ignored
    faces and images without detections or faces."""
    preds, gts, keeps = {}, {}, {}
    for i in range(n_images):
        g = rng.integers(0, 6)
        gt = np.column_stack([rng.uniform(0, 200, (g, 2)), rng.uniform(8, 60, (g, 2))])
        p = rng.integers(0, 9) if i % 5 else 0
        pr = np.column_stack([rng.uniform(0, 200, (p, 2)), rng.uniform(8, 60, (p, 2)),
                              rng.uniform(0, 1, p)])
        if g and p:  # some hits
            k = min(g, p)
            pr[:k, :4] = gt[:k] + rng.normal(0, 2, (k, 4))
        gts[f"img{i}"], preds[f"img{i}"] = gt, pr
        keeps[f"img{i}"] = rng.uniform(size=g) > 0.3
    return preds, gts, keeps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_widerface_eval_copy_equals_fdtpu(seed, tmp_path):
    preds, gts, keeps = random_split(np.random.default_rng(seed))
    for k in (None, keeps):
        got, want = twe.evaluate_split(preds, gts, k), jwe.evaluate_split(preds, gts, k)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got, want = twe.norm_scores(preds), jwe.norm_scores(preds)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    rng = np.random.default_rng(seed)
    r, p = np.sort(rng.uniform(size=20)), rng.uniform(size=20)
    assert twe.voc_ap(r, p) == jwe.voc_ap(r, p)
    boxes = np.column_stack([rng.uniform(0, 1, 16), rng.uniform(0, 150, (16, 4))]).astype(np.float32)
    mask = rng.uniform(size=16) > 0.4
    np.testing.assert_array_equal(twe.detections_to_official(boxes, mask, (160, 160), (500, 377)),
                                  jwe.detections_to_official(boxes, mask, (160, 160), (500, 377)))
    official = {f"0--Synthetic/{k}": v for k, v in preds.items()}
    n = twe.write_official_predictions(official, tmp_path / "port")
    assert n == jwe.write_official_predictions(official, tmp_path / "fdtpu") == len(preds)
    for f in sorted((tmp_path / "fdtpu").rglob("*.txt")):
        assert (tmp_path / "port" / f.relative_to(tmp_path / "fdtpu")).read_text() == f.read_text()
