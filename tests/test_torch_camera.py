"""The port's ``demo_model --camera`` loop and its image demo's synthetic
frames, against fdtpu's ``demo_model.py``.

A stub ``cv2`` module stands in for OpenCV and a webcam: it serves numpy
BGR frames drawn from a seed, then a failed read, and records what the loop
draws and shows. Both demos serve the same float32 PoolResnet (fdtpu's
params, converted through ``compat``) at 160 px with 16 filters and 2
blocks. The gate is ``tests/test_torch_slice.py``'s end to end: the same
count of rectangles a frame, each corner within one pixel (the two
forwards differ by ~2e-7, and a corner that lies that close to a half
pixel may round the other way).
"""

import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)
import torch

from fdtpu.models import Detector as JaxDetector
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu_torch import demo_model
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.models import Detector, PoolResnet

REPO = Path(__file__).resolve().parents[1]
SIZE = (160, 160)
S = 5
PROB, IOU, CAP = 0.5, 0.3, 32
ESC = 27


def fdtpu_demo():
    """fdtpu's root ``demo_model.py`` as a module."""
    spec = importlib.util.spec_from_file_location("fdtpu_demo_model", REPO / "demo_model.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def detectors(seed=3):
    jm = JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S, num_residual_blocks=2,
                       dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SIZE, 3)))
    tm = PoolResnet(16, SIZE, S, 2)
    tm.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"])))
    return JaxDetector(jm, variables, PROB, IOU, CAP), Detector(tm, PROB, IOU, CAP,
                                                                 dtype=torch.float32)


def bgr_frames(n=6, hw=(120, 150), seed=0):
    return list(np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8))


def stub_cv2(frames, keys=()):
    """A ``cv2`` module whose camera serves ``frames`` and then fails a
    read; ``waitKey`` returns ``keys`` in turn (then -1). ``cv2.log`` holds
    each frame's rectangles, the frames shown and the calls that end the
    loop."""
    cv2 = types.ModuleType("cv2")
    cv2.COLOR_BGR2RGB, cv2.COLOR_RGB2BGR = 4, 5
    cv2.log = {"rects": [], "shown": [], "released": 0, "destroyed": 0, "reads": 0}
    keys = list(keys)

    class VideoCapture:
        def __init__(self, index):
            assert index == 0

        def read(self):
            cv2.log["reads"] += 1
            if not frames:
                return False, None
            cv2.log["rects"].append([])
            return True, frames.pop(0)

        def release(self):
            cv2.log["released"] += 1

    def cvtColor(img, code):
        assert code in (cv2.COLOR_BGR2RGB, cv2.COLOR_RGB2BGR)
        return np.ascontiguousarray(img[..., ::-1])

    def rectangle(img, p1, p2, color, thickness):
        assert color == (255, 0, 0) and thickness == 2
        assert all(isinstance(v, int) for v in (*p1, *p2))
        cv2.log["rects"][-1].append((*p1, *p2))

    def imshow(name, img):
        cv2.log["shown"].append(img.copy())

    def waitKey(ms):
        return keys.pop(0) if keys else -1

    def destroyAllWindows():
        cv2.log["destroyed"] += 1

    cv2.VideoCapture, cv2.cvtColor, cv2.rectangle = VideoCapture, cvtColor, rectangle
    cv2.imshow, cv2.waitKey, cv2.destroyAllWindows = imshow, waitKey, destroyAllWindows
    return cv2


def run(run_camera, det, monkeypatch, frames, keys=()):
    cv2 = stub_cv2(list(frames), keys)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    run_camera(det)
    return cv2.log


def test_camera_draws_fdtpus_rectangles(monkeypatch):
    jdet, tdet = detectors()
    frames = bgr_frames()
    want = run(fdtpu_demo().run_camera, jdet, monkeypatch, frames)
    got = run(demo_model.run_camera, tdet, monkeypatch, frames)
    assert len(got["rects"]) == len(want["rects"]) == len(got["shown"]) == 6
    assert sum(map(len, want["rects"])) > 0
    for g, w in zip(got["rects"], want["rects"]):
        assert len(g) == len(w)
        if w:
            np.testing.assert_allclose(np.array(g), np.array(w), atol=1, rtol=0)
    for g, w in zip(got["shown"], want["shown"]):
        assert g.shape == w.shape == (*SIZE, 3) and g.dtype == w.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_camera_draws_the_boxes_of_predict(monkeypatch):
    """Each frame's rectangles are the corners of ``predict``'s kept boxes
    on the RGB frame, as ints, and the frame shown is the resized one in
    BGR."""
    _, tdet = detectors()
    frames = bgr_frames(seed=1)
    log = run(demo_model.run_camera, tdet, monkeypatch, frames)
    assert log["reads"] == 7  # six frames, then the failed read
    for frame, rects, shown in zip(frames, log["rects"], log["shown"]):
        norm, boxes, mask = tdet.predict(frame[..., ::-1])
        kept = boxes[mask].numpy()
        assert len(rects) == int(mask.sum())
        want = [(int(x), int(y), int(x) + int(w), int(y) + int(h)) for _, x, y, w, h in kept]
        assert rects == want
        np.testing.assert_array_equal(shown[..., ::-1],
                                      (norm.numpy() * 255).astype(np.uint8))


@pytest.mark.parametrize("stop", ["failed_read", "esc"])
def test_camera_stops_and_releases(monkeypatch, stop):
    _, tdet = detectors()
    if stop == "esc":  # ESC after the second frame: the third is never read
        log = run(demo_model.run_camera, tdet, monkeypatch, bgr_frames(), keys=(-1, ESC))
        assert log["reads"] == 2 and len(log["shown"]) == 2
    else:
        log = run(demo_model.run_camera, tdet, monkeypatch, bgr_frames(n=3))
        assert log["reads"] == 4 and len(log["shown"]) == 3
    assert log["released"] == log["destroyed"] == 1


def test_camera_without_cv2_raises(monkeypatch):
    _, tdet = detectors()
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    with pytest.raises(ImportError, match="OpenCV"):
        demo_model.run_camera(tdet)


def test_main_dispatches_on_camera(monkeypatch):
    cv2 = stub_cv2(bgr_frames(n=2))
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    demo_model.main(["--camera", "--device", "cpu", "--input", "160", "--patches", "5",
                     "--filters", "16", "--blocks", "2"])
    assert len(cv2.log["shown"]) == 2 and cv2.log["released"] == 1
    assert demo_model.parse_args([]).camera is False


def test_images_on_an_empty_directory_makes_synthetic_frames(tmp_path):
    """Three synthetic frames, annotated under the names fdtpu's demo
    gives them."""
    jdet, tdet = detectors()
    (tmp_path / "empty").mkdir()
    fdtpu_demo().run_images(jdet, str(tmp_path / "empty"), str(tmp_path / "fdtpu"))
    demo_model.run_images(tdet, str(tmp_path / "empty"), str(tmp_path / "port"))
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    want = sorted(p.name for p in (tmp_path / "fdtpu").iterdir())
    assert got == want and len(got) == 3
