"""Each mix's control flow, end to end on the CPU at a tiny size: set-up,
the measured or the traced window, the release, the reference and the
judge, with the program computing in float32 (its augmentation keeps its
bfloat16 chain) against the float32 reference."""

import pytest

from perfbench.tests import tiny

TRAIN, STREAM = tiny.cells("train"), tiny.cells("stream")
TRAIN_LIMITS = {"loss1_gap": 1e-3, "grad_gap_median": 3e-2, "box_grad_gap": 3e-2,
                "change_gap": 3e-2}
STREAM_LIMITS = {"box_gap_px": 2.0, "score_gap": 1e-3, "kept_gap": 0.0, "nms_gap": 1e-3,
                 "overlap": 0.0, "malformed": 0.0}


def limits(name):
    return TRAIN_LIMITS if name in TRAIN else STREAM_LIMITS


@pytest.mark.parametrize("trace", [False, True], ids=["measured", "traced"])
@pytest.mark.parametrize("name", TRAIN + STREAM)
def test_dry_run(name, trace, tmp_path):
    out = tiny.run(name, trace=trace, limits=limits(name), tmp_path=tmp_path)
    assert list(out)[:3] == ["correct", "attempted", "failed"] and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:  # no device ran anything: every device reader finds nothing
        assert out["device"]["busy_s"] == 0 and "breakdown" in out
        assert set(out["metrics"]) <= {"frame_p50_ms.stream", "frame_p95_ms.stream"}
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
        rate = "train_img_s" if name in TRAIN else "frame_ms"
        assert out["metrics"][rate]["value"] > 0


def test_ssd_reference_follows_exactly(tmp_path):
    """Without augmentation and in float32 the program's first steps and
    the reference's agree to rounding: the draws, the row order, the
    targets, the loss, SAM and Adam are the same."""
    out = tiny.run("ssd16-train-b24-480", limits=TRAIN_LIMITS, tmp_path=tmp_path)
    assert all(c["value"] < 1e-5 for c in out["checks"].values()), out["checks"]
