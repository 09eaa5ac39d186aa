"""``run.py`` as a check of the benchmark calls it: it refuses to report
without a card and in a directory that holds only the benchmark, and on a
card it prints the result line."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "ssd16-stream-b1-480", "--seed", str(2**31 + 11), "--seconds", "2",
        "--trace", "0"]


def run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_refuses_in_a_bare_directory(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_on_the_card(card):
    out = run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"frame_ms", "setup_s"}
