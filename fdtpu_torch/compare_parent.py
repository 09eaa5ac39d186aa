"""Time K1-K4 and the b1 predict of two trees in turns on one card: this
checkout and another (an older commit unpacked with ``git archive``).

Run from the root of the checkout, on a machine with a CUDA card::

    git archive <commit> | tar -x -C build/parent
    python -m fdtpu_torch.compare_parent --parent build/parent [--pairs 10]
    python -m fdtpu_torch.compare_parent --parent build/parent \
        --profile-train "--batch 8 --size 480 --grid 10" [--pairs 2]

Each turn is a process that runs this checkout's ``chip_smoke.py
--kernel-times`` from a copy outside both trees, with one tree first on
``PYTHONPATH``: that tree's ``fdtpu_torch`` (its wrappers and its CUDA
sources, built into its own ``build/fdtpu_torch/``) is what gets timed, on
the same inputs. The turns go in pairs, each pair in the other order from
the one before (two pairs: parent, this, this, parent), so that drift on
the card hits both alike. Prints each turn's lines, then one JSON line with
every turn's times and the mean and median of each tree's turns.

``--profile-train ARGS`` times the eager train step instead: each turn is
``python -m fdtpu_torch.profile_train ARGS`` in one tree, in three arms,
``parent``, ``this`` (the same flags) and ``this --graph`` (with a
capturable Adam, so its eager arm is the eager step a replaying Trainer
would run, then the graph arm), each pair of turns in the order parent,
this, this --graph and the next reversed. The JSON line holds each turn's
step ms by CUDA events, device busy ms and kernels a step (and the graph
arm's step ms and idle share), and the median of each arm's turns.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
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


PROFILE_ARMS = {"parent": [], "this": [], "this --graph": ["--graph"]}
PROFILE_LINES = {  # field -> the first line of profile_train's output that gives it
    "step_ms": re.compile(r"^step ([\d.]+) ms by CUDA events", re.M),
    "busy_ms": re.compile(r"^device busy ([\d.]+) ms/step", re.M),
    "kernels": re.compile(r"([\d.]+) kernels/step", re.M),
    "graph_step_ms": re.compile(r"^graph arm: step ([\d.]+) ms", re.M),
    "graph_idle": re.compile(r"^graph arm: .*idle share ([-\d.]+)", re.M),
}


def profile_turn(tree: Path, args: list[str]) -> dict:
    """One ``profile_train`` process in ``tree``: its parsed numbers."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, "-m", "fdtpu_torch.profile_train", *args], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"profile_train in {tree} failed:\n{proc.stderr[-4000:]}")
    heading = re.search(r"^== .*\[(.*)\]$", proc.stdout, re.M)
    out = {"card": heading.group(1) if heading else None}
    for field, pattern in PROFILE_LINES.items():
        m = pattern.search(proc.stdout)
        if m:
            out[field] = float(m.group(1))
    return out


def compare_profile(trees: dict, args: list[str], pairs: int) -> dict:
    arms = list(PROFILE_ARMS)
    turns = {arm: [] for arm in arms}
    turn_order = [arm for i in range(pairs) for arm in (arms if i % 2 == 0 else arms[::-1])]
    for arm in turn_order:
        tree = trees["parent" if arm == "parent" else "this"]
        print(f"[turn] {arm}: {tree}", flush=True)
        turns[arm].append(profile_turn(tree, [*args, *PROFILE_ARMS[arm]]))
    median = {arm: {field: statistics.median(t[field] for t in ts)
                    for field in PROFILE_LINES if all(field in t for t in ts)}
              for arm, ts in turns.items()}
    return {"args": args, "order": turn_order, "turns": turns, "median": median}


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
    p.add_argument("--profile-train", metavar="ARGS", default=None,
                   help="time the eager train step: profile_train's flags, quoted")
    args = p.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "this": ROOT}
    if args.profile_train is not None:
        result = compare_profile(trees, shlex.split(args.profile_train), args.pairs)
        print(json.dumps({"compare_parent_profile_train": result}))
        return
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
