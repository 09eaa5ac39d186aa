"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, on the CPU at a tiny
size (the harness's look for a chip skipped)."""

import pytest
import torch

from perfbench.tests import tiny
from perfbench.tests.test_pb_dry_run import STREAM, STREAM_LIMITS, TRAIN, TRAIN_LIMITS


def _train_step_wrapped(monkeypatch, wrap):
    from fdtpu_torch.train import loop

    make = loop.make_train_step

    def patched(*args, **kwargs):
        return wrap(make(*args, **kwargs))

    monkeypatch.setattr(loop, "make_train_step", patched)


def unchanged(step):
    """A step that returns its state unchanged."""
    from fdtpu_torch.train.graphs import state_tensors

    def run(state, *batch):
        saved = [t.clone() for t in state_tensors(state)]
        state, scalars = step(state, *batch)
        with torch.no_grad():
            for t, s in zip(state_tensors(state), saved):
                t.copy_(s)
        return state, scalars

    return run


def half_batch(step):
    """Half of the batch left out, the loss taken over the rest."""
    def run(state, images, boxes, box_mask, sample_mask=None):
        mask = torch.ones(images.shape[:1], dtype=torch.bool) if sample_mask is None \
            else sample_mask.clone()
        mask[images.shape[0] // 2:] = False
        return step(state, images, boxes, box_mask, mask)

    return run


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault(name, fault, monkeypatch, tmp_path):
    _train_step_wrapped(monkeypatch, fault)
    out = tiny.run(name, limits=TRAIN_LIMITS, tmp_path=tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", STREAM)
def test_answer_altered(name, monkeypatch, tmp_path):
    """A kept box moved where the answer is produced."""
    from fdtpu_torch.models import detector

    predict = detector.Detector.predict

    def altered(self, image, *args, **kwargs):
        norm, boxes, mask = predict(self, image, *args, **kwargs)
        boxes = boxes.clone()
        boxes[0, 1] += 9.0
        return norm, boxes, mask

    monkeypatch.setattr(detector.Detector, "predict", altered)
    out = tiny.run(name, limits=STREAM_LIMITS, tmp_path=tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", STREAM)
def test_kept_rows_dropped(name, monkeypatch, tmp_path):
    """Half of each answer's kept rows (rounded up) dropped where the
    answer is produced."""
    from fdtpu_torch.models import detector

    from perfbench.control import drop_half

    predict = detector.Detector.predict

    def dropped(self, image, *args, **kwargs):
        norm, boxes, mask = predict(self, image, *args, **kwargs)
        return (norm, *drop_half(boxes, mask))

    monkeypatch.setattr(detector.Detector, "predict", dropped)
    out = tiny.run(name, limits=STREAM_LIMITS, tmp_path=tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["kept_gap"]["value"] > 0.25, out["checks"]
