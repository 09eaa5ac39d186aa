"""The training numbers' box rows: ``judge.box_gap`` on a case worked by
hand, each family's ``box_rows`` naming rows of its heads, and the premise
of ``box_grad_gap``: mining does not move the gradient of those rows."""

import json

import pytest
import torch

from perfbench import cell, data, judge, reference, weights
from perfbench.reference import objectives
from perfbench.reference.train import _inputs
from perfbench.tests import tiny

BENCH = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((cell.ROOT / c["file"]).read_text()) for c in BENCH["configs"]}


def test_box_gap_by_hand():
    """Three leaves of box norms 3, 4 and 12 (median 4): gaps of 1, 2 and
    6 weigh 1/4, 2/4 and 6/12; their root mean square."""
    ref = {"a": torch.tensor([[9.0], [3.0]]), "b": torch.tensor([[9.0], [4.0]]),
           "c": torch.tensor([[0.0], [12.0]])}
    prog = {"a": torch.tensor([[0.0], [2.0]]), "b": torch.tensor([[1.0], [6.0]]),
            "c": torch.tensor([[5.0], [6.0]])}
    rows = [(k, slice(1, 2)) for k in ("a", "b", "c")]
    want = ((0.25**2 + 0.5**2 + 0.5**2) / 3) ** 0.5
    assert judge.box_gap(prog, ref, rows) == pytest.approx(want)
    assert judge.box_gap(ref, ref, rows) == 0.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_box_rows_are_rows_of_the_heads(name):
    """Every leaf ``box_rows`` names writes a model row, and its rows are
    the row's four box coordinates."""
    model = CONFIGS[name]["model"]
    ref = reference.family(CONFIGS[name]["reference"])
    shapes = {k: shape for k, shape, _ in ref.param_specs(model)}
    rows = ref.box_rows(model)
    assert rows and all(shapes[k][0] == ref.ROW for k, _ in rows)
    assert all(range(ref.ROW)[r] == range(1, ref.ROW) for _, r in rows)


def test_mining_leaves_the_box_rows_gradient():
    """The SSD's loss at two mining ratios: other negatives, the same
    gradient of the heads' box rows (and another of their score rows)."""
    name = next(n for n in tiny.cells("train")
                if tiny.spec(n).config["reference"] == "ssd")
    c = tiny.spec(name).config
    m, t = c["model"], c["train"]
    ref = reference.family(c["reference"])
    params = weights.draw(ref.param_specs(m), 5, "cpu")
    images, boxes, masks = data.faces(5, "train", 4, m["input_shape"][0], t["box_capacity"],
                                      12, "cpu")
    imgs, (enc, gt_locs) = _inputs(ref, m, t, images, boxes, masks, None, None)
    grads = []
    for ratio in (1, 3):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        pred = ref.forward(leaves, imgs, m)
        loss = objectives.ssd_loss(pred[..., 0], pred[..., 1:5], enc[..., 0], gt_locs, ratio)
        grads.append(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
    rows = ref.box_rows(m)
    assert all(torch.equal(grads[0][k][r], grads[1][k][r]) for k, r in rows)
    assert not all(torch.equal(grads[0][k][:1], grads[1][k][:1]) for k, _ in rows)
