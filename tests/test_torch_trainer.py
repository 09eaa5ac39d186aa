"""The port's Trainer against fdtpu's Trainer, at 160 px with 16 filters,
2 blocks, batch 4 and 8 synthetic images (each package's loader over its
own, byte-identical copy of the dataset; the val split holds 6 images, so
its last batch is padded).

Both sides: float32, augmentation off, dropout 0, the same initial params
(fdtpu's, converted through ``compat``), shuffle off, 2 epochs, SGD at
lr 1e-2 (Adam's sign-like first steps would amplify rounding noise, as in
``tests/test_torch_train.py``), once with SAM and once without.
Tolerances (the two forwards differ by summation order only, ~2e-7,
``tests/test_torch_models.py``, and eight SGD steps carry it on):

* per-epoch train loss and metrics, val loss, iou, recall, precision and
  F1: rtol 1e-4;
* final params: atol 1e-5;
* step counts, epochs, checkpoint steps: equal;
* the ``.log`` lines: the same epochs, splits and metric names in the same
  order, each value within the rtol above (a line prints six decimals,
  finer than the two frameworks agree); the ``.jsonl`` records the same
  apart from ``time``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

from fdtpu.data import BatchLoader as JaxBatchLoader
from fdtpu.data import WIDERFaceDataSource as JaxSource
from fdtpu.data import load_targets as jax_load_targets
from fdtpu.data import make_synthetic_widerface as jax_make_synthetic
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu.train import Trainer as JaxTrainer
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import PoolResnet
from fdtpu_torch.train import Trainer
from fdtpu_torch.utils.config import TrainConfig

SIZE = (160, 160)
S = 5
RTOL = 1e-4
PARAMS_ATOL = 1e-5
NMS = (0.05, 0.5, 64)  # a low threshold: the fresh model's boxes reach the metrics


def jax_model():
    return JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                         dropout=0.0, head_dropout=0.0, dtype=jnp.float32)


def torch_model():
    return PoolResnet(16, SIZE, S, 2, dropout=0.0, head_dropout=0.0)


def loaders(root, source_cls, loader_cls, parse, **extra):
    train = source_cls(parse(root, "train", 3), SIZE, box_capacity=4, error_log=None, **extra)
    val = source_cls(parse(root, "val", 3)[:6], SIZE, box_capacity=4, error_log=None, **extra)
    return loader_cls(train, 4), loader_cls(val, 4)


def make_dataset(root, make):
    make(root, 8, split="train", seed=0)
    make(root, 8, split="val", seed=1)
    return root


def config_kw(use_sam, tmp, name):
    return dict(optimizer="sgd", learning_rate=1e-2, use_sam=use_sam, max_epochs=2, batch_size=4,
                box_capacity=4, visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                log_path=str(tmp / f"logs_{name}" / "out.log"), log_every_steps=0)


@pytest.fixture(scope="module", params=[True, False], ids=["sam", "no-sam"])
def runs(request, tmp_path_factory):
    """fdtpu's Trainer and the port's, two epochs each from the same params."""
    use_sam = request.param
    tmp = tmp_path_factory.mktemp("sam" if use_sam else "nosam")
    jroot = make_dataset(tmp / "fdtpu_data", jax_make_synthetic)
    root = make_dataset(tmp / "port_data", make_synthetic_widerface)

    jtrain, jval = loaders(jroot, JaxSource, JaxBatchLoader, jax_load_targets, use_native=False)
    jt = JaxTrainer(jax_model(), JaxTrainConfig(**config_kw(use_sam, tmp, "fdtpu")), jtrain, jval,
                    augment=False, nms_params=NMS, run_name="fdtpu")
    start = poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params))

    module = torch_model()
    module.load_state_dict(start)
    train, val = loaders(root, WIDERFaceDataSource, BatchLoader, load_targets, use_native=False)
    tt = Trainer(module, TrainConfig(**config_kw(use_sam, tmp, "port")), train, val,
                 augment=False, nms_params=NMS, run_name="port", device="cpu")
    return {"fdtpu": (jt, jt.fit()), "port": (tt, tt.fit()), "tmp": tmp}


def assert_metrics_close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7, err_msg=k)


def test_epoch_metrics_match_fdtpu(runs):
    (_, got), (_, want) = runs["port"], runs["fdtpu"]
    for split in ("train", "val"):
        assert set(want[split]) == {"loss", "iou", "recall", "precision", "f1"}
        assert_metrics_close(got[split], want[split])
    assert want["train"]["iou"] > 0 and want["val"]["iou"] > 0  # boxes reached the metrics


def test_final_params_and_steps_match_fdtpu(runs):
    (tt, _), (jt, _) = runs["port"], runs["fdtpu"]
    assert tt.state.step == int(jt.state.step) == 4
    assert tt.epoch == jt.epoch == 2
    want = poolresnet_state_dict(jax.tree.map(np.asarray, jt.state.params))
    for name, p in tt.state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAMS_ATOL,
                                   rtol=0, err_msg=name)
    ckpts = sorted(p.name for p in (runs["tmp"] / "ckpt" / "port").iterdir())
    jckpts = sorted(p.name for p in (runs["tmp"] / "ckpt" / "fdtpu").iterdir())
    assert ckpts == [f"{n}.pt" for n in jckpts] == ["step_00000002.pt", "step_00000004.pt"]


def parse_line(line: str):
    parts = line.split()
    return parts[:2], [(k, float(v)) for k, v in (p.split("=") for p in parts[2:])]


def test_logs_match_fdtpu(runs):
    """The ``.log`` lines, the ``.jsonl`` records and the TensorBoard
    scalars, each package's decoded by its own reader."""
    import json

    from fdtpu.utils.tb import read_scalars as jax_read_scalars
    from fdtpu_torch.utils.tb import read_scalars

    port, ref = runs["tmp"] / "logs_port", runs["tmp"] / "logs_fdtpu"
    got = (port / "out.log").read_text().splitlines()
    want = (ref / "out.log").read_text().splitlines()
    assert len(got) == len(want) == 4  # train + val, two epochs
    for g, w in zip(got, want):
        (ghead, gvals), (whead, wvals) = parse_line(g), parse_line(w)
        assert ghead == whead
        assert [k for k, _ in gvals] == [k for k, _ in wvals]
        np.testing.assert_allclose([v for _, v in gvals], [v for _, v in wvals], rtol=RTOL,
                                   atol=2e-6)
    skip = ("time", "epoch", "split")
    for g, w in zip((port / "out.jsonl").read_text().splitlines(),
                    (ref / "out.jsonl").read_text().splitlines()):
        g, w = json.loads(g), json.loads(w)
        assert list(g) == list(w)
        assert (g["epoch"], g["split"]) == (w["epoch"], w["split"])
        assert_metrics_close({k: g[k] for k in g if k not in skip},
                             {k: w[k] for k in w if k not in skip})
    (gtb,), (wtb,) = (list((d / "tb").glob("events.out.tfevents.*")) for d in (port, ref))
    gsc, wsc = read_scalars(gtb), jax_read_scalars(wtb)
    assert [step for step, _ in gsc] == [step for step, _ in wsc] == [0, 0, 1, 1]
    for (_, g), (_, w) in zip(gsc, wsc):
        assert_metrics_close(g, w)
