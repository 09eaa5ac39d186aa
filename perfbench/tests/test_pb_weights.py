"""The weights both sides get: the draw of each tiny cell is the one it
has been since the benchmark began (a new initialiser moves no family's
draw), and ``ones`` fills its slice alone."""

import hashlib

import pytest
import torch

from perfbench import reference, weights
from perfbench.tests import tiny

SEED = 2**40 + 7
# sha256 of every parameter's name and float32 bytes in spec order, first 16 hex digits,
# as the draw gave them before ``ones`` existed
DRAWN = {
    "poolresnet128-train-b8-480": "9a0c0b320514e73d",
    "poolresnet128-stream-b1-480": "9a0c0b320514e73d",
    "ssd16-train-b24-480": "97a6faf12ae46d28",
    "ssd16-stream-b1-480": "97a6faf12ae46d28",
}


def digest(params: dict) -> str:
    h = hashlib.sha256()
    for name, v in params.items():
        h.update(name.encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", list(DRAWN))
def test_tiny_draw_unchanged(name):
    c = tiny.spec(name).config
    specs = reference.family(c["reference"]).param_specs(c["model"])
    assert digest(weights.draw(specs, SEED, "cpu")) == DRAWN[name]


def test_ones_takes_its_slice():
    """A ``ones`` parameter is 1 and leaves every other parameter's draw
    where it was: each takes its slice of the one uniform draw."""
    base = [("a", (3, 4), ("lecun_normal", 4)), ("b", (5,), ("zeros", 4)),
            ("c", (2, 3), ("torch_uniform", 3))]
    ones = [base[0], ("b", (5,), ("ones", 4)), base[2]]
    got, want = weights.draw(ones, SEED, "cpu"), weights.draw(base, SEED, "cpu")
    assert torch.equal(got["b"], torch.ones(5))
    assert torch.equal(got["a"], want["a"]) and torch.equal(got["c"], want["c"])


def test_unknown_initialiser_raises():
    with pytest.raises(ValueError, match="unknown initialiser 'twos'"):
        weights.draw([("a", (2,), ("twos", 1))], SEED, "cpu")
