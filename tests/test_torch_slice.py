"""The serving slice as a whole: u8 frames -> /255 -> PoolResnet forward ->
fused decode+filter+NMS, port against fdtpu from the same params (float32).

Exact where both decoders see the same forward output. End to end, the two
forwards differ by ~2e-7 (test_torch_models.py), so the gate is: masks
equal, scores within the forward's 2e-5 bar, and coordinates within one
pixel, because a corner that lies within 2e-7 of a half pixel may round
the other way.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

from fdtpu.kernels import grid_decode_tables, pallas_decode_filter_nms_batch
from fdtpu.models import Detector as JaxDetector
from fdtpu.models import PoolResnet as JaxPoolResnet
from fdtpu_torch.compat import poolresnet_state_dict
from fdtpu_torch.core import compact_boxes
from fdtpu_torch.models import Detector, PoolResnet

REPO = Path(__file__).resolve().parents[1]
SIZE = (160, 160)
S = 5
PROB, IOU, CAP = 0.5, 0.3, 32


def detectors(seed=1):
    jm = JaxPoolResnet(filters=16, input_shape=SIZE, num_patches=S,
                       num_residual_blocks=2, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SIZE, 3)))
    tm = PoolResnet(16, SIZE, S, 2)
    tm.load_state_dict(poolresnet_state_dict(jax.tree.map(np.asarray, variables["params"])))
    jdet = JaxDetector(jm, variables, PROB, IOU, CAP)
    tdet = Detector(tm, PROB, IOU, CAP, dtype=torch.float32)
    return jdet, tdet


def frames(b, hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, *hw, 3), dtype=np.uint8)


def assert_end_to_end(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1.0, rtol=0)


def test_predict_matches_fdtpu():
    jdet, tdet = detectors(seed=3)
    for seed, hw in ((0, (211, 173)), (1, SIZE)):  # host resize, and none
        img = frames(1, hw, seed)[0]
        jnorm, jb, jm = jdet.predict(img)
        norm, boxes, mask = tdet.predict(img)
        assert boxes.shape == (CAP, 5) and mask.shape == (CAP,) and norm.shape == (*SIZE, 3)
        np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), atol=1e-6, rtol=0)
        want = compact_boxes(jb, jm)
        got = compact_boxes(boxes, mask)
        assert 0 < got.shape[0] < CAP
        assert_end_to_end(got, want)


def test_batch_path_matches_fdtpu_and_k1():
    jdet, tdet = detectors(seed=2)
    u8 = frames(4, SIZE, seed=4)
    jout = np.asarray(jdet.apply(jnp.asarray(u8, jnp.float32) / 255.0))
    tout = tdet.apply(torch.from_numpy(u8).float() / 255.0)
    np.testing.assert_allclose(tout.numpy(), jout, atol=2e-5, rtol=0)
    tables = grid_decode_tables(S, SIZE)

    def k1(out):
        b, m = pallas_decode_filter_nms_batch(
            jnp.asarray(out).reshape(4, S * S, 5), tables, PROB, IOU, CAP, interpret=True
        )
        return np.asarray(b), np.asarray(m)

    # exact: both decoders on the same forward output
    for out in (jout, tout.numpy()):
        boxes, mask = tdet.non_max_suppression(torch.tensor(out))
        wb, wm = k1(out)
        np.testing.assert_array_equal(mask.numpy(), wm)
        np.testing.assert_array_equal(boxes.numpy()[..., 0], wb[..., 0])
        np.testing.assert_allclose(boxes.numpy()[..., 1:], wb[..., 1:], atol=1e-4, rtol=0)

    # end to end: the port's forward + decode against fdtpu's forward + K1
    boxes, mask = tdet.non_max_suppression(tout)
    wb, wm = k1(jout)
    assert mask.any()
    np.testing.assert_array_equal(mask.numpy(), wm)
    for i in range(4):
        assert_end_to_end(compact_boxes(boxes[i], mask[i]), wb[i][wm[i]])


def test_demo_runs_on_cpu(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, hw in enumerate(((150, 170), (96, 200))):
        Image.fromarray(frames(1, hw, seed=i)[0]).save(img_dir / f"frame{i}.png")
    proc = subprocess.run(
        [sys.executable, "-m", "fdtpu_torch.demo_model", "--device", "cpu",
         "--images", str(img_dir), "--out", str(tmp_path / "out"),
         "--input", "160", "--patches", "5", "--filters", "8", "--blocks", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        assert line.startswith(f"frame{i}.png: ") and " faces in " in line and line.endswith(" ms")
        assert (tmp_path / "out" / f"frame{i}.png").exists()


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card(tmp_path):
    for cwd in (REPO, tmp_path):  # the checkout, and the script alone
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "fdtpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "fdtpu"}
