"""The port's Trainer on its own, on the CPU, at 160 px with 16 filters,
2 blocks, batch 4 and 7 synthetic train images (the last batch padded):

* the resident driver (``device_data``) equals the streamed one bit for
  bit, train and val, with augmentation, dropout, SAM and Adam on;
* a resumed run continues bit for bit: two epochs equal one epoch, a save,
  a new Trainer from other params, ``maybe_resume``, then one more; the
  shuffled feed included;
* ``positional_crop`` resolves from the loader's shuffle flag, as fdtpu's
  ``test_trainer_resolves_positional_crop_from_shuffle`` checks it;
* what is not allowed raises: a data-parallel Trainer without its process
  group, or with a batch its ranks do not divide.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.models import PoolResnet
from fdtpu_torch.train import Trainer
from fdtpu_torch.train.checkpoint import latest_checkpoint, restore_variables
from fdtpu_torch.utils.config import TrainConfig

SIZE = (160, 160)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wider")
    make_synthetic_widerface(root, 7, split="train", seed=0)
    make_synthetic_widerface(root, 6, split="val", seed=1)
    return root


def loaders(root, shuffle=False, rotate_prob=0.0):
    train = WIDERFaceDataSource(load_targets(root, "train", 3), SIZE, box_capacity=4,
                                error_log=None, rotate_prob=rotate_prob)
    val = WIDERFaceDataSource(load_targets(root, "val", 3), SIZE, box_capacity=4, error_log=None)
    return BatchLoader(train, 4, shuffle=shuffle, seed=5), BatchLoader(val, 4)


def model(seed=0):
    torch.manual_seed(seed)
    return PoolResnet(16, SIZE, 5, 2)


def config(tmp, **kw):
    base = dict(learning_rate=1e-3, max_epochs=2, batch_size=4, box_capacity=4,
                visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                log_path=str(tmp / "logs" / "out.log"), log_every_steps=0, seed=3)
    return TrainConfig(**{**base, **kw})


def params(trainer):
    return [p.detach().clone() for p in trainer.state.module.parameters()]


def assert_same_state(a, b):
    assert a.state.step == b.state.step
    for p, q in zip(a.state.module.parameters(), b.state.module.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(a.state.module.parameters(), b.state.module.parameters()):
        sa, sb = a.state.optimizer.state[p], b.state.optimizer.state[q]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_resident_equals_streamed(root, tmp_path):
    """Shuffle off: the resident permutation is the source order, real rows
    first, so both feeds give every step the same rows, and the step's
    generator (reseeded from the seed and the step) the same draws."""
    outs, trainers = [], []
    for resident in (False, True):
        train, val = loaders(root)
        t = Trainer(model(), config(tmp_path / str(resident), device_data=resident), train, val,
                    device="cpu")
        outs.append(t.fit())
        trainers.append(t)
    streamed, resident = outs
    assert type(trainers[1].driver).__name__ == "ResidentDriver"
    assert streamed == resident  # every float bit-equal
    assert set(streamed["train"]) == {"loss", "iou", "precision", "recall", "f1"}
    assert_same_state(*trainers)
    assert trainers[0].state.step == 4


@pytest.mark.parametrize("shuffle", [False, True])
def test_resume_continues_bit_for_bit(root, tmp_path, shuffle):
    train, val = loaders(root, shuffle)
    straight = Trainer(model(), config(tmp_path / "a"), train, val, device="cpu")
    want = straight.fit(2)

    train, val = loaders(root, shuffle)
    first = Trainer(model(), config(tmp_path / "b"), train, val, device="cpu")
    first.fit(1)
    assert latest_checkpoint(tmp_path / "b" / "ckpt" / "run").name == "step_00000002.pt"

    train, val = loaders(root, shuffle)
    resumed = Trainer(model(seed=1), config(tmp_path / "b"), train, val, device="cpu")
    assert resumed.maybe_resume() and resumed.epoch == 1 and resumed.state.step == 2
    got = resumed.fit(2)
    assert got == want
    assert_same_state(resumed, straight)
    sd = restore_variables(tmp_path / "b" / "ckpt" / "run" / "step_00000004.pt")
    for name, p in straight.state.module.named_parameters():
        assert torch.equal(sd[name], p.detach())


def test_trainer_resolves_positional_crop_from_shuffle(root, tmp_path):
    train, val = loaders(root)
    shuffled = BatchLoader(train.source, 4, drop_last=True, shuffle=True)
    assert Trainer(model(), config(tmp_path / "a"), shuffled, val,
                   device="cpu").config.positional_crop is True
    assert Trainer(model(), config(tmp_path / "b"), train, val,
                   device="cpu").config.positional_crop is False
    assert Trainer(model(), config(tmp_path / "c", positional_crop=False), shuffled, val,
                   device="cpu").config.positional_crop is False


def test_device_data_with_host_rotation_raises(root, tmp_path):
    train, val = loaders(root, rotate_prob=0.2)
    t = Trainer(model(), config(tmp_path, device_data=True), train, val, device="cpu")
    with pytest.raises(ValueError, match="rotate_device"):
        t.train_epoch()


@pytest.mark.parametrize("dp", [2, -1])
def test_data_parallel_raises(dp, root, tmp_path):
    """``data_parallel`` builds: -1 without a process group is one process;
    n ranks need a global batch that n divides and a group of n ranks
    (tests/test_torch_parallel.py runs them)."""
    for ok in (None, 0, 1, dp):
        TrainConfig(data_parallel=ok)
    with pytest.raises(ValueError, match="data_parallel"):
        TrainConfig(data_parallel=-2)
    train, val = loaders(root)
    if dp == -1:
        t = Trainer(model(), config(tmp_path, data_parallel=-1), train, val, device="cpu")
        assert (t.group, t.rank, t.world, t.primary) == (None, 0, 1, True)
        with pytest.raises(ValueError, match="process group of 2 ranks"):
            Trainer(model(), config(tmp_path, data_parallel=2), train, val, device="cpu")
        return
    odd = BatchLoader(train.source, 3, drop_last=True)
    with pytest.raises(ValueError, match="divisible"):
        Trainer(model(), config(tmp_path, data_parallel=dp, batch_size=3), odd, val,
                device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        BatchLoader(train.source, 3, process_shard=(0, dp))


def test_profile_visualize_and_nan_check(root, tmp_path, monkeypatch):
    """``profile`` traces the next epoch to a Chrome trace; the first batch
    of each split is drawn; ``nan_check`` turns on autograd's anomaly
    mode."""
    monkeypatch.chdir(tmp_path)
    train, val = loaders(root)
    before = torch.is_anomaly_enabled()
    try:
        t = Trainer(model(), config(tmp_path, visualize_first_batch=True, nan_check=True,
                                    max_epochs=1), train, val, device="cpu")
        assert torch.is_anomaly_enabled()
        t.profile(str(tmp_path / "prof")).fit()
    finally:
        torch.autograd.set_detect_anomaly(before)
    assert (tmp_path / "prof" / "train_epoch_0.json").stat().st_size > 0
    assert sorted(p.name for p in (tmp_path / "imgs").iterdir()) == [
        "train_epoch_0.png", "validation_epoch_0.png"]
    assert np.isfinite(t.eval_epoch()["loss"])
