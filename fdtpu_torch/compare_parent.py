"""Time K1-K4 of two trees in turns on one card: this checkout and another
(an older commit unpacked with ``git archive``).

Run from the root of the checkout, on a machine with a CUDA card::

    git archive <commit> | tar -x -C build/parent
    python -m fdtpu_torch.compare_parent --parent build/parent

Each turn is a process that runs this checkout's ``chip_smoke.py
--kernel-times`` from a copy outside both trees, with one tree first on
``PYTHONPATH``: that tree's ``fdtpu_torch`` (its wrappers and its CUDA
sources, built into its own ``build/fdtpu_torch/``) is what gets timed, on
the same inputs. The order is parent, this, this, parent, so that drift on
the card hits both alike. Prints each turn's lines, then one JSON line with
every turn's times and the mean of each tree's two turns.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("parent", "this", "this", "parent")


def turn(script: Path, tree: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, str(script), "--kernel-times"], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"kernel times of {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["kernel_times"]


def mean(turns: list[dict]) -> dict:
    """Per kernel and shape, the mean of the turns' ``ms`` (and, for K1,
    ``kernel_ms`` and ``host_us``)."""
    out = {}
    for key in ("decode_filter_nms", "shears"):
        rows = []
        for group in zip(*(t[key] for t in turns)):
            row = dict(group[0])
            for field in ("ms", "kernel_ms", "host_us"):
                if field in row:
                    row[field] = sum(r[field] for r in group) / len(group)
            rows.append(row)
        out[key] = rows
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--parent", required=True, help="root of the other tree")
    args = p.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "this": ROOT}
    # a copy outside both trees, so that sys.path[0] is neither
    scratch = ROOT / "build" / "compare_parent"
    scratch.mkdir(parents=True, exist_ok=True)
    script = scratch / "chip_smoke.py"
    shutil.copyfile(ROOT / "chip_smoke.py", script)
    turns = {"parent": [], "this": []}
    for label in ORDER:
        print(f"[turn] {label}: {trees[label]}", flush=True)
        turns[label].append(turn(script, trees[label]))
    print(json.dumps({"compare_parent": {
        "card": turns["this"][0]["card"], "order": list(ORDER), "turns": turns,
        "mean": {label: mean(t) for label, t in turns.items()},
    }}))


if __name__ == "__main__":
    main()
