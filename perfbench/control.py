"""The readings a cell's limits are set from, on the card, at the cell's
own size:

* the program's, over many seeds, in one process: each seed's set-up (the
  first epoch, whose first steps are the checked ones), or for a serving
  cell a short window at the cell's load, then the check as a run makes it;
* the control's: the plain reference put in the program's place and
  computed in float8 (the precision below the configuration's bfloat16,
  ``reference/nn.py``), judged against the float32 reference;
* the reference with its layers rounded to bfloat16, which should read as
  the program does (a look at the control's emulation);
* for a training cell, the fault of half of each batch left out (the loss
  over the rest), planted in the reference put in the program's place. A
  step that leaves the state unchanged reads ``change_gap`` 1 by the
  measure itself;
* for a serving cell, the fault of half of each answer's kept rows
  (rounded up) dropped where the answer is made, planted in the float32
  reference put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--stream-seconds 1] [--out FILE]

Prints one JSON line a reading and a summary, which ``--out`` also
writes. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cell, data, judge, reference, weights  # noqa: E402
from perfbench.modes import cell_class  # noqa: E402
from perfbench.modes.stream import stream_weights  # noqa: E402
from perfbench.reference.nn import Precision  # noqa: E402
from perfbench.reference.serve import frame_rows, greedy_nms  # noqa: E402
from perfbench.reference.train import follow  # noqa: E402


def program_reading(spec, seed: int, device, stream_seconds: float) -> dict:
    workdir = Path(tempfile.gettempdir()) / "perfbench"
    workdir.mkdir(parents=True, exist_ok=True)
    c = cell_class(spec.mix["mode"])(spec.name, spec.config, spec.mix, seed, device, workdir)
    c.setup()
    if spec.mix["mode"] == "stream":
        c.window(stream_seconds)
    c.release()
    numbers, _ = c.check()
    if spec.mix["mode"] == "train":
        numbers["details"] = c.details
    return numbers


def train_inputs(spec, seed: int, device):
    conf, t = spec.config, spec.config["train"]
    ref = reference.family(conf["reference"])
    made = data.faces(seed, "train", conf["train_images"], conf["model"]["input_shape"][0],
                      t["box_capacity"], spec.mix["faces_mean"], device)
    return ref, weights.draw(ref.param_specs(conf["model"]), seed, device), made


def control_train(spec, seed: int, device) -> dict:
    """The float8 reference and the half-batch fault, each against the
    float32 reference."""
    conf, t = spec.config, spec.config["train"]
    ref, params, made = train_inputs(spec, seed, device)
    steps = spec.mix["check_steps"]
    with reference.strict_float32():
        base = follow(ref, conf["model"], t, params, made, seed, steps)
        low = follow(ref, conf["model"], t, params, made, seed, steps, Precision("float8"))
        half = follow(ref, conf["model"], t, params, made, seed, steps, fault="half")
        bf16 = follow(ref, conf["model"], t, params, made, seed, steps, Precision("bfloat16"))
    rows = ref.box_rows(conf["model"])
    return {"control": judge.train_numbers(low, base, rows),
            "half": judge.train_numbers(half, base, rows),
            "bfloat16": judge.train_numbers(bf16, base, rows)}


def drop_half(rows, mask):
    """An answer with the second half of its kept rows (rounded up)
    dropped."""
    rows, mask = rows.clone(), mask.clone()
    k = int(mask.sum())
    rows[k // 2:] = 0.0
    mask[k // 2:] = False
    return rows, mask


def control_stream(spec, seed: int, device) -> dict:
    """The float8 reference's answers (its own decode and greedy NMS),
    the bfloat16 one's, and the float32 one's with half its kept rows
    dropped, each judged against the float32 reference's candidates."""
    conf, m, d = spec.config, spec.config["model"], spec.config["detector"]
    ref = reference.family(conf["reference"])
    frames, _, _ = data.faces(seed, "frames", spec.mix["frame_pool"], m["input_shape"][0],
                              d["nms_capacity"], spec.mix["faces_mean"], device)
    params = stream_weights(conf, seed, list(frames.cpu().numpy()), device)
    prob, iou, cap = d["probability_threshold"], d["iou_threshold"], d["nms_capacity"]
    with reference.strict_float32():
        base = frame_rows(ref, params, frames, m)
        lower = {kind: frame_rows(ref, params, frames, m, Precision(name))
                 for kind, name in (("control", "float8"), ("bfloat16", "bfloat16"))}
    lower["half_kept"] = base
    out = {}
    for kind, low in lower.items():
        numbers = []
        for b, lo in zip(base, low):
            scores, boxes = ref.candidates(b, m)
            rows, mask = greedy_nms(*ref.candidates(lo, m), prob, iou, cap)
            if kind == "half_kept":
                rows, mask = drop_half(rows, mask)
            numbers.append(judge.answer_numbers(rows, mask, scores, boxes, prob, iou, cap))
        out[kind] = judge.serving_numbers(numbers)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--stream-seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA card")
    device = torch.device("cuda", 0)
    spec = cell.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        rows.append({"seed": seed, "program": program_reading(spec, seed, device,
                                                              args.stream_seconds),
                     "s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    run_control = control_stream if spec.mix["mode"] == "stream" else control_train
    for seed in control_seeds:
        t = time.perf_counter()
        rows.append({"seed": seed, **run_control(spec, seed, device), "s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(device)}
    for kind in ("program", "control", "half", "half_kept", "bfloat16"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {name: {"min": min(g[name] for g in got),
                                    "max": max(g[name] for g in got)}
                             for name in got[0] if name != "details"}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}) + "\n")


if __name__ == "__main__":
    main()
