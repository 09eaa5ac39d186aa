"""The row shear's design study (``fdtpu_torch/bench_shear_designs.py``):
what can be checked without a card. The designs run, are held bit-equal to
the plain version and are timed only on the card."""

from __future__ import annotations

import re
import subprocess
import sys
import torch_threads  # noqa: F401  (torch's threads under xdist)
from pathlib import Path

from fdtpu_torch import bench_shear_designs as bsd

REPO = Path(__file__).resolve().parents[1]


def test_bench_needs_a_card():
    proc = subprocess.run([sys.executable, "-m", "fdtpu_torch.bench_shear_designs"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr
    assert "shear_designs" not in proc.stdout


def test_designs_are_the_instances_built():
    """Every ring and bulk instance the source builds is timed, and no other;
    the study includes the shipped kernel's own source."""
    text = bsd.SOURCE.read_text()
    built = {(int(a), int(b)) for a, b in re.findall(r"stages == (\d+) && run == (\d+)", text)}
    for design in (bsd.RING, bsd.BULK):
        timed = {(s, r) for _, d, s, r in bsd.DESIGNS if d == design}
        assert timed == built, design
    assert '#include "../rotate_shear.cu"' in text
    assert [d for _, d, _, _ in bsd.DESIGNS].count(bsd.SHIPPED) == 1
    assert [d for _, d, _, _ in bsd.DESIGNS].count(bsd.SHUFFLE) == 1
