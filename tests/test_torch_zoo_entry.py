"""The zoo through the port's entry points on the CPU (``--device cpu``),
on 8 synthetic train and 8 val images at 96 px, b4:

* ``train_model --model mobilenetv3 | resnet | separable --rotate-device``:
  one epoch, then ``--resume`` for a second, equal bit for bit (params,
  BatchNorm statistics, Adam's state and the step) to two epochs straight.
  With ``--rotate-device`` every draw of a step comes from the step's
  generator; the host rotation of the default draws from the source's own
  stream, which a new process starts again (in fdtpu too);
* ``--pretrained-backbone`` on a synthetic reference ``.pth``: the backbone
  (BatchNorm statistics included) is the archive's, the head the fresh
  model's; with another family it exits;
* ``run_validation_epoch``, ``demo_model`` and ``load_checkpoint`` on a
  reference ``.pth`` (MobileNetV3, wrapped in ``ReferenceLayoutGrid``);
* the Trainer against fdtpu's Trainer for MobileNetV3 at 96 px, as
  ``tests/test_torch_trainer.py`` holds them for PoolResnet: float32,
  augmentation off, the same initial params and statistics, shuffle off,
  one epoch (two steps, the second with train metrics, then the val
  epoch on the running statistics) of SGD at lr 1e-3. Epoch metrics rtol
  1e-4 (the forwards differ by summation order only); final params atol
  1e-5 and BatchNorm statistics rtol 1e-4, atol 1e-6. Without SAM: on
  these synthetic frames a convolution over a flat background gives one
  value at thousands of pixels, so when it sits near a ReLU's kink a
  change in the last bit flips them all, and SAM's perturbed point lands
  on such kinks (single gradient tensors at that point differ by a few %
  between the two summation orders, the norm by 3e-5). The SAM step is
  held on random frames in ``tests/test_torch_zoo.py``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.models import MobileNetV3Backbone as JaxMobileNetV3
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch import demo_model, load_checkpoint, run_validation_epoch, train_model
from fdtpu_torch.compat import mobilenetv3_state_dict
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import MobileNetV3Backbone, build_model
from fdtpu_torch.train import Trainer
from fdtpu_torch.utils.config import DetectorConfig, TrainConfig
from test_torch_torch_import import reference_mobilenetv3_state_dict, save_archive

SIZE = 96
FLAGS = {  # each family at 96 px, b4; the grid follows from the geometry
    "mobilenetv3": ["--patches", "3"],
    "resnet": ["--patches", "3", "--filters", "8", "--blocks", "2"],
    "separable": ["--patches", "16", "--filters", "8", "--blocks", "2"],
}
COMMON = ["--input", str(SIZE), "--batch-size", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("wider")
    make_synthetic_widerface(root, 8, split="train", seed=0)
    make_synthetic_widerface(root, 8, split="val", seed=1)
    return root


def train(work: Path, data: Path, family: str, *extra: str) -> Path:
    work.mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        return Path(train_model.main(["--data-dir", str(data), "--model", family,
                                      *FLAGS[family], *COMMON, "--rotate-device", *extra]))


@pytest.mark.parametrize("family", list(FLAGS))
def test_train_model_resumes_bit_for_bit(family, data, tmp_path):
    straight = train(tmp_path / "a", data, family, "--epochs", "2")
    train(tmp_path / "b", data, family, "--epochs", "1")
    resumed = train(tmp_path / "b", data, family, "--epochs", "2", "--resume")
    assert straight.name == resumed.name == "step_00000004.pt"
    assert straight.parent.name.startswith(f"{family}_")
    a, b = (torch.load(p, weights_only=True) for p in (straight, resumed))
    assert a["step"] == b["step"] == 4
    assert a["module"].keys() == b["module"].keys()
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    if family == "mobilenetv3":
        stats = [k for k in a["module"] if k.endswith("running_var")]
        assert len(stats) == 34 and not torch.equal(a["module"][stats[0]],
                                                    torch.ones_like(a["module"][stats[0]]))
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "medium_model_3x3_96.pth"
    sd = reference_mobilenetv3_state_dict(seed=4)
    save_archive(sd, path)
    return path, sd


def test_pretrained_backbone_imports_the_backbone(data, archive, tmp_path):
    path, sd = archive
    ckpt = train(tmp_path, data, "mobilenetv3", "--epochs", "0", "--pretrained-backbone", str(path))
    got = torch.load(ckpt, weights_only=True)["module"]
    assert torch.equal(got["conv_stem.weight"], sd["feature_extractor.0.weight"])
    assert torch.equal(got["blocks.3.bn2.running_mean"],
                       sd["feature_extractor.3.2.0.bn2.running_mean"])
    fresh = build_model("mobilenetv3", DetectorConfig(input_shape=(SIZE, SIZE), num_patches=3),
                        "cpu", torch.Generator().manual_seed(0))
    assert torch.equal(got["head.weight"], fresh.head.weight)  # the seed's head, not the archive's
    assert not torch.equal(got["head.weight"], sd["out.weight"])
    with pytest.raises(SystemExit, match="mobilenetv3"):
        train(tmp_path / "r", data, "resnet", "--epochs", "0", "--pretrained-backbone", str(path))


def test_reference_pth_through_the_entry_points(data, archive, tmp_path, monkeypatch):
    """A reference MobileNetV3 archive validates (the default family), is
    served by ``demo_model`` and ``load_checkpoint``; each decodes the
    wrapped model's output, whose map is the plain import's transposed."""
    path, _ = archive
    monkeypatch.chdir(tmp_path)
    args = ["--data-dir", str(data), "--input", str(SIZE), "--patches", "3", "--batch-size", "4",
            "--device", "cpu", "--prob-threshold", "0.05"]
    metrics = run_validation_epoch.main([*args, "--checkpoint", str(path), "--with-ap"])
    assert set(metrics) == {"loss", "iou", "recall", "precision", "f1", "AP@0.5"}
    assert all(np.isfinite(v) for v in metrics.values())
    fresh = run_validation_epoch.main(args)  # random weights: another loss
    assert fresh["loss"] != metrics["loss"]
    small = ["--input", str(SIZE), "--patches", "3", "--device", "cpu", "--model", "mobilenetv3",
             "--checkpoint", str(path)]
    gt, pred = load_checkpoint.main(["--data-dir", str(data), *small])
    assert gt.shape[1] == 5 and pred.ndim == 2 and pred.shape[1] == 5
    images = data / "WIDER_val" / "images" / "0--Synthetic"
    demo_model.main(["--images", str(images), "--out", "annotated", *small])
    assert len(list((tmp_path / "annotated").glob("*.png"))) == 8


# -- the Trainer against fdtpu's, MobileNetV3 ----------------------------------------


def loaders(root, source_cls, loader_cls, parse, **extra):
    train_ = source_cls(parse(root, "train", 3), (SIZE, SIZE), box_capacity=4, error_log=None,
                        **extra)
    val = source_cls(parse(root, "val", 3)[:6], (SIZE, SIZE), box_capacity=4, error_log=None,
                     **extra)
    return loader_cls(train_, 4), loader_cls(val, 4)


def config_kw(tmp, name):
    return dict(optimizer="sgd", learning_rate=1e-3, use_sam=False, max_epochs=1, batch_size=4,
                box_capacity=4, visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                log_path=str(tmp / f"logs_{name}" / "out.log"), log_every_steps=0)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainers")
    for name, make in (("fdtpu", jax_make_synthetic), ("port", make_synthetic_widerface)):
        make(tmp / f"{name}_data", 8, split="train", seed=0)
        make(tmp / f"{name}_data", 8, split="val", seed=1)
    nms = (0.05, 0.5, 64)
    jtrain, jval = loaders(tmp / "fdtpu_data", JaxSource, JaxBatchLoader, jax_load_targets,
                           use_native=False)
    jt = JaxTrainer(JaxMobileNetV3((SIZE, SIZE), 3, dtype=np.float32),
                    JaxTrainConfig(**config_kw(tmp, "fdtpu")), jtrain, jval, augment=False,
                    nms_params=nms, run_name="fdtpu")
    module = MobileNetV3Backbone((SIZE, SIZE), 3)
    module.load_state_dict(mobilenetv3_state_dict(jax.tree.map(np.asarray, jt.state.params),
                                                  jax.tree.map(np.asarray, jt.state.batch_stats)))
    train_, val = loaders(tmp / "port_data", WIDERFaceDataSource, BatchLoader, load_targets,
                          use_native=False)
    tt = Trainer(module, TrainConfig(**config_kw(tmp, "port")), train_, val, augment=False,
                 nms_params=nms, run_name="port", device="cpu")
    return {"fdtpu": (jt, jt.fit()), "port": (tt, tt.fit())}


def test_trainer_matches_fdtpu_mobilenetv3(trainers):
    (tt, got), (jt, want) = trainers["port"], trainers["fdtpu"]
    for split in ("train", "val"):
        assert list(got[split]) == list(want[split])
        for k in want[split]:
            np.testing.assert_allclose(got[split][k], want[split][k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{split} {k}")
    assert tt.state.step == int(jt.state.step) == 2
    sd = mobilenetv3_state_dict(jax.tree.map(np.asarray, jt.state.params),
                                jax.tree.map(np.asarray, jt.state.batch_stats))
    for name, t in tt.state.module.state_dict().items():
        tol = dict(rtol=1e-4, atol=1e-6) if "running" in name else dict(rtol=0, atol=1e-5)
        np.testing.assert_allclose(t.numpy(), sd[name].numpy(), err_msg=name, **tol)
