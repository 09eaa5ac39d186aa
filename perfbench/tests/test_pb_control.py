"""The control comes out not correct: the plain reference put in the
program's place and computed in float8, judged against the float32
reference by each cell's own limits, at a size the CPU holds; and so do
the faults planted in the reference (half of each batch left out, half of
each answer's kept rows dropped). (The
readings the limits were set from are the card's, at the cells' sizes:
``perfbench/control.py``.)"""

import pytest

from perfbench import judge
from perfbench.control import control_stream, control_train
from perfbench.tests import tiny


@pytest.mark.parametrize("name", tiny.cells("train"))
def test_train_control_fails(name):
    got = control_train(tiny.spec(name), 2**33 + 5, "cpu")
    lim = judge.limits(name)
    assert not judge.verdict(got["control"], lim)[0], got["control"]
    assert not judge.verdict(got["half"], lim)[0], got["half"]


@pytest.mark.parametrize("name", tiny.cells("stream"))
def test_stream_control_fails(name):
    got = control_stream(tiny.spec(name), 2**33 + 5, "cpu")
    assert not judge.verdict(got["control"], judge.limits(name))[0], got["control"]
    assert not judge.verdict(got["half_kept"], judge.limits(name))[0], got["half_kept"]
