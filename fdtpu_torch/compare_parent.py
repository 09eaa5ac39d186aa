"""Time K1-K4 and the b1 predict of two trees in turns on one card: this
checkout and another (an older commit unpacked with ``git archive``).

Run from the root of the checkout, on a machine with a CUDA card::

    git archive <commit> | tar -x -C build/parent
    python -m fdtpu_torch.compare_parent --parent build/parent [--pairs 10]

Each turn is a process that runs this checkout's ``chip_smoke.py
--kernel-times`` from a copy outside both trees, with one tree first on
``PYTHONPATH``: that tree's ``fdtpu_torch`` (its wrappers and its CUDA
sources, built into its own ``build/fdtpu_torch/``) is what gets timed, on
the same inputs. The turns go in pairs, each pair in the other order from
the one before (two pairs: parent, this, this, parent), so that drift on
the card hits both alike. Prints each turn's lines, then one JSON line with
every turn's times and the mean and median of each tree's turns.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def order(pairs: int) -> list[str]:
    """``pairs`` pairs of turns, the first parent first, then alternating."""
    return [label for i in range(pairs)
            for label in (("parent", "this") if i % 2 == 0 else ("this", "parent"))]


def turn(script: Path, tree: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, str(script), "--kernel-times"], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"kernel times of {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["kernel_times"]


def summary(turns: list[dict], stat=statistics.mean) -> dict:
    """Per kernel and shape, ``stat`` over the turns of ``ms`` (and, for
    K1, ``kernel_ms`` and ``host_us``); ``stat`` of the b1 predict times."""
    out = {}
    for key in ("decode_filter_nms", "shears"):
        rows = []
        for group in zip(*(t[key] for t in turns)):
            row = dict(group[0])
            for field in ("ms", "kernel_ms", "host_us"):
                if field in row:
                    row[field] = stat([r[field] for r in group])
            rows.append(row)
        out[key] = rows
    if all("predict_b1" in t for t in turns):
        out["predict_b1"] = {field: stat([t["predict_b1"][field] for t in turns])
                             for field in ("median_ms", "min_ms")}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--parent", required=True, help="root of the other tree")
    p.add_argument("--pairs", type=int, default=2, help="pairs of turns (default 2)")
    args = p.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "this": ROOT}
    # a copy outside both trees, so that sys.path[0] is neither
    scratch = ROOT / "build" / "compare_parent"
    scratch.mkdir(parents=True, exist_ok=True)
    script = scratch / "chip_smoke.py"
    shutil.copyfile(ROOT / "chip_smoke.py", script)
    turns = {"parent": [], "this": []}
    turn_order = order(args.pairs)
    for label in turn_order:
        print(f"[turn] {label}: {trees[label]}", flush=True)
        turns[label].append(turn(script, trees[label]))
    print(json.dumps({"compare_parent": {
        "card": turns["this"][0]["card"], "order": turn_order, "turns": turns,
        "mean": {label: summary(t) for label, t in turns.items()},
        "median": {label: summary(t, statistics.median) for label, t in turns.items()},
    }}))


if __name__ == "__main__":
    main()
