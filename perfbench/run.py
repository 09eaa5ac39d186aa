"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, as its last lines on standard error, each number
that decides ``correct`` beside its limit; then, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, with ``--trace 1``, ``breakdown``, and
last ``checks``. Exits non-zero, and prints no result, without a CUDA card
(or with fewer than the cell asks for), when the process holds JAX or the
JAX package after the window, or when anything fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import cell

    spec = cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    print(f"{args.workload} seed {args.seed}: {card_line()}", file=sys.stderr)
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    held = cell.forbidden_modules()
    if held:
        print(f"the run holds JAX or the JAX package: {held}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None  # JSON has no NaN: a number that is not finite fails its check
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
