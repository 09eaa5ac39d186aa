"""The port's SSD entry points on the CPU at 64 px with 4 filters, b2, on
16 synthetic train and 4 val images (quarter-epochs of 4 images, 2 steps):
``train_model_ssd`` trains, writes checkpoints and resumes bit for bit;
``run_validation_epoch --model ssd``, ``load_checkpoint --model ssd`` and
``demo_model --model ssd`` read its checkpoint; the resident driver takes
each quarter-epoch off a fresh permutation of the whole split. Its flags
and defaults are ``train_model_ssd.py``'s (read from its source: this file
imports no JAX)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu_torch import demo_model, load_checkpoint, run_validation_epoch, train_model_ssd
from fdtpu_torch.core.priors import priors_on
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import SSD, build_model
from fdtpu_torch.train import Trainer
from fdtpu_torch.train.checkpoint import restore_variables
from fdtpu_torch.utils.config import SSDConfig, TrainConfig

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--input", "64", "--filters", "4", "--device", "cpu"]
TRAIN = ["--data-dir", "data", "--batch-size", "2", *SMALL]
RUN = "ssd_4_64x64"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    work = tmp_path_factory.mktemp("work")
    make_synthetic_widerface(work / "data", 16, split="train", seed=0, max_faces=4)
    make_synthetic_widerface(work / "data", 4, split="val", seed=1, max_faces=4)
    return work


@pytest.fixture(scope="module")
def trained(work):
    """Two quarter-epochs of ``train_model_ssd``; its last checkpoint."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        return Path(train_model_ssd.main([*TRAIN, "--epochs", "2"]))


def reference_defaults() -> dict:
    """The defaults of ``train_model_ssd.py``'s flags, from its source."""
    tree = ast.parse((REPO / "train_model_ssd.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            name = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[name] = ast.literal_eval(kw["default"])
            elif getattr(kw.get("action"), "value", None) == "store_true":
                out[name] = False
    return out


def test_flags_and_defaults_match_train_model_ssd_py():
    got = vars(train_model_ssd.parse_args([]))
    want = reference_defaults()
    left_out = {"platform"}
    assert set(got) == set(want) - left_out | {"device", "multihost"}
    assert {k: got[k] for k in want if k not in left_out} == {
        k: v for k, v in want.items() if k not in left_out}
    assert (got["filters"], got["input"], got["batch_size"], got["box_capacity"]) == (16, 480, 24, 128)
    assert got["device"] == "cuda" and got["augment"] is False
    assert got["data_parallel"] == 0 and got["multihost"] is False


def test_train_model_ssd_writes_checkpoints_logs_and_resumes(work, trained):
    assert trained == work / "checkpoints" / RUN / "step_00000004.pt"  # 2 x 2 steps
    sd = restore_variables(trained)
    assert sd["stem.weight"].shape == (4, 3, 3, 3) and sd["heads.3.weight"].shape == (5, 64)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in sd.values())
    lines = (work / "logs" / f"out_{RUN}.log").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["split=training", "split=validation"] * 2
    # one more quarter-epoch from the checkpoint = a straight run of three
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        resumed = train_model_ssd.main([*TRAIN, "--epochs", "3", "--resume"])
        straight_dir = work / "straight"
        straight_dir.mkdir()
        (straight_dir / "data").symlink_to(work / "data")
        mp.chdir(straight_dir)
        straight = train_model_ssd.main([*TRAIN, "--epochs", "3"])
    assert Path(resumed).name == Path(straight).name == "step_00000006.pt"
    a, b = restore_variables(resumed), restore_variables(straight)
    for name in b:
        assert torch.equal(a[name], b[name]), name


def test_run_validation_epoch_ssd_reads_the_checkpoint(work, trained, monkeypatch):
    monkeypatch.chdir(work)
    args = ["--data-dir", "data", "--model", "ssd", "--checkpoint", str(trained),
            "--batch-size", "2", *SMALL]
    plain = run_validation_epoch.main(args)
    with_ap = run_validation_epoch.main([*args, "--with-ap"])
    assert set(plain) == {"loss", "iou", "precision", "recall", "f1"}
    for k in plain:  # one pass of the same eval step: the same means
        np.testing.assert_allclose(with_ap[k], plain[k], rtol=1e-6, err_msg=k)
    assert 0.0 <= with_ap["AP@0.5"] <= 1.0 and np.isfinite(with_ap["loss"])
    fresh = run_validation_epoch.main([a for a in args if a not in ("--checkpoint", str(trained))])
    assert fresh["loss"] != plain["loss"]  # the checkpoint was loaded


def test_load_checkpoint_and_demo_ssd(work, trained, monkeypatch):
    monkeypatch.chdir(work)
    gt, pred = load_checkpoint.main(["--data-dir", "data", "--model", "ssd", "--checkpoint",
                                     str(trained), *SMALL])
    assert gt.shape[1] == 5 and pred.ndim == 2 and pred.shape[1] == 5
    images = work / "data" / "WIDER_val" / "images" / "0--Synthetic"
    demo_model.main(["--images", str(images), "--out", "annotated", "--model", "ssd",
                     "--checkpoint", str(trained), *SMALL])
    assert len(list((work / "annotated").glob("*.png"))) == 4


def resident_run(work, tmp, resident: bool, shuffle: bool):
    """Two quarter-epochs of the SSD Trainer, float32, Adam, augmentation
    and train metrics off (every batch takes ``train_step``); the boxes of
    every batch its train step was given."""
    src = WIDERFaceDataSource(load_targets(work / "data", "train", 120), (64, 64), 8,
                              error_log=None)
    val = WIDERFaceDataSource(load_targets(work / "data", "val", 120), (64, 64), 8,
                              error_log=None)
    train = BatchLoader(src, 2, shuffle=shuffle, seed=1, drop_last=True, epoch_fraction=4)
    cfg = TrainConfig(learning_rate=1e-3, use_sam=False, max_epochs=2, device_data=resident,
                      train_metrics=False, visualize_first_batch=False, log_every_steps=0,
                      checkpoint_dir=str(tmp / "ckpt"), log_path=str(tmp / "logs" / "out.log"))
    torch.manual_seed(0)
    t = Trainer(SSD(4, (64, 64), (8, 4, 2, 1)), cfg, train, BatchLoader(val, 2),
                augment=False, nms_params=(0.05, 0.5, 128), device="cpu")
    seen = []
    step = t.train_step

    def recording(state, images, boxes, *rest):
        seen.append(boxes.clone())
        return step(state, images, boxes, *rest)

    t.train_step = recording
    return t, t.fit(), seen


def test_resident_quarter_epochs(work, tmp_path):
    """Shuffle off: the resident driver's quarter-epochs are the streamed
    loader's (the first quarter of the split), bit for bit. Shuffle on:
    each quarter-epoch is a fresh draw of 4 of the 16 images."""
    (ts, streamed, _), (tr, resident, _) = (
        resident_run(work, tmp_path / str(r), r, shuffle=False) for r in (False, True))
    assert type(tr.driver).__name__ == "ResidentDriver"
    assert streamed == resident and tr.state.step == ts.state.step == 4
    for p, q in zip(ts.state.module.parameters(), tr.state.module.parameters()):
        assert torch.equal(p, q)
    _, _, seen = resident_run(work, tmp_path / "shuffled", True, shuffle=True)
    epochs = [torch.cat(seen[:2]), torch.cat(seen[2:])]
    assert len(seen) == 4 and not torch.equal(*epochs)
    assert all(bool((e[:, 0, 3] > 0).all()) for e in epochs)  # real images, each with a face


def test_build_model_ssd_from_ssd_config_and_lecun_option():
    cfg = SSDConfig(filters=4, input_shape=(64, 64), patch_sizes=(8, 4, 2, 1))
    m = build_model("ssd", cfg, "cpu", torch.Generator().manual_seed(0),
                    compute_dtype=torch.bfloat16)
    assert m.patch_sizes == (8, 4, 2, 1) and m.stem.weight.dtype == torch.float32
    out = m.eval()(torch.rand(2, 64, 64, 3))
    assert out.dtype == torch.float32 and out.shape == (2, 85, 5)
    # the priors cached by a first forward in inference mode serve autograd
    other = SSD(4, (64, 64), (8, 4, 2, 1))
    priors_on.cache_clear()
    with torch.inference_mode():
        other(torch.rand(1, 64, 64, 3))
    other(torch.rand(1, 64, 64, 3)).sum().backward()
    lecun = SSD(4, (64, 64), (8, 4, 2, 1), torch_init=False)
    assert not lecun.stem.bias.any() and not lecun.heads[0].bias.any()
    with pytest.raises(ValueError, match="patch size"):
        SSD(4, (64, 64), (9, 4, 2, 1)).eval()(torch.rand(1, 64, 64, 3))
