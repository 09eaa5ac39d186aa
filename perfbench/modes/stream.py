"""The ``stream`` mode: one caller in a closed loop sends frames through the
program's serving Detector, as ``demo_model`` runs over a video or a
folder of frames.

Set-up makes a pool of distinct uint8 frames at the model's input size
(``data.faces``) and the weights from the seed, with each head's score
bias centred so that a frame of the pool has about as many eligible
candidates as the configuration's trained maps (``eligible_per_frame``;
``weights.center_scores``, by the float32 reference), builds
the Detector as ``load_checkpoint`` does (the float32 master module, the configuration's
compute dtype, thresholds and capacity) and sends every frame of the pool
once, which captures the predict program's CUDA graph. A request is
``Detector.predict(frame)`` (the pinned staging copy, the replay of ``/255``,
the forward and K1, the outputs' clones) and the copy of its boxes and
mask to the host; the next request follows at once, cycling through the
pool.

The measured window sends requests until ``seconds`` have passed;
``frame_ms`` is the window's length, which ends in
``torch.cuda.synchronize``, over the requests. The traced window sends the
mix's ``trace_frames`` requests under the profiler and times each by the
host clock. Every answer is kept; the check judges each distinct answer
of a frame against the reference's candidates of that frame.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import data, judge, program, reference, weights
from perfbench.reference.serve import frame_rows
from perfbench.roofline import flops
from perfbench.trace import traced


def stream_weights(config: dict, seed: int, frames: list, device) -> dict:
    """The seed's weights with each head's score bias centred on the
    pool's frames (``weights.center_scores``)."""
    ref = reference.family(config["reference"])
    params = weights.draw(ref.param_specs(config["model"]), seed, device)
    pool = torch.from_numpy(np.stack(frames)).to(device)
    with reference.strict_float32():
        weights.center_scores(ref, params, config["model"], pool, config["eligible_per_frame"])
    return params


class Cell:
    """One serving cell: ``setup``, ``window`` or ``traced``, ``release``,
    ``check`` (``perfbench/cell.py`` calls them in that order)."""

    def __init__(self, name: str, config: dict, mix: dict, seed: int, device: torch.device,
                 workdir: Path):
        self.name, self.config, self.mix, self.seed, self.device = name, config, mix, seed, device
        self.det_cfg = config["detector"]
        self.answers: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.latencies_ms: list[float] = []

    def setup(self) -> None:
        from fdtpu_torch.models import DTYPES, Detector

        c, m = self.config, self.config["model"]
        frames, _, _ = data.faces(self.seed, "frames", self.mix["frame_pool"],
                                  m["input_shape"][0], self.det_cfg["nms_capacity"],
                                  self.mix["faces_mean"], self.device)
        self.frames = [f for f in frames.cpu().numpy()]
        del frames
        self.weights = stream_weights(c, self.seed, self.frames, self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)  # the program's peak alone
        self.det = Detector(program.module(c, self.weights, self.device, train=False),
                            probability_threshold=self.det_cfg["probability_threshold"],
                            iou_threshold=self.det_cfg["iou_threshold"],
                            nms_capacity=self.det_cfg["nms_capacity"],
                            dtype=DTYPES[c["compute_dtype"]])
        for i in range(len(self.frames)):
            self._request(i, keep=False)
        self.sent = 0

    def _request(self, i: int, keep: bool = True) -> None:
        frame = i % len(self.frames)
        _, boxes, mask = self.det.predict(self.frames[frame])
        boxes, mask = boxes.cpu().numpy(), mask.cpu().numpy()
        if keep:
            self.answers.append((frame, boxes, mask))

    def window(self, seconds: float) -> tuple[float, dict, int, int]:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._request(self.sent + n)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        self.sent += n
        return t0, {"frame_ms": window_s * 1e3 / n}, n, 0

    def traced(self):
        def run():
            for k in range(self.mix["trace_frames"]):
                t = time.perf_counter()
                with record_function("perfbench/request"):
                    self._request(self.sent + k)
                self.latencies_ms.append((time.perf_counter() - t) * 1e3)

        _, window = traced(run, self.device)
        self.sent += self.mix["trace_frames"]
        return window, self.mix["trace_frames"], 0

    def layer_context(self) -> dict:
        return {"mode": "stream", "images_per_unit": 1,
                "flops_per_image": flops.forward_flops(self.config["reference"],
                                                       self.config["model"]),
                "latencies_ms": self.latencies_ms, "nms": getattr(self, "nms_work", [])}

    def release(self) -> None:
        del self.det
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """-> ``(numbers, malformed answers)``; also keeps each answer's K1
        work (candidates, eligible, kept) for ``nms_roofline``."""
        ref = reference.family(self.config["reference"])
        m, d = self.config["model"], self.det_cfg
        prob, iou, cap = d["probability_threshold"], d["iou_threshold"], d["nms_capacity"]
        frames = torch.from_numpy(np.stack(self.frames)).to(self.device)
        with reference.strict_float32():
            rows = frame_rows(ref, self.weights, frames, m)
        cands = [ref.candidates(r, m) for r in rows]
        distinct: dict = {}
        for frame, boxes, mask in self.answers:
            key = (frame, boxes.tobytes(), mask.tobytes())
            if key not in distinct:
                distinct[key] = [frame, boxes, mask, 0]
            distinct[key][3] += 1
        numbers, bad, self.nms_work = [], 0, []
        for frame, boxes, mask, count in distinct.values():
            b = torch.from_numpy(boxes).to(self.device)
            k = torch.from_numpy(mask).to(self.device)
            scores, cand_boxes = cands[frame]
            if judge.malformed(b, k, prob):
                bad += count
                continue
            numbers.append(judge.answer_numbers(b, k, scores, cand_boxes, prob, iou, cap))
            self.nms_work.append((count, rows.shape[1], int((scores > prob).sum()),
                                  int(k.sum()), cap))
        out = judge.serving_numbers(numbers)
        out["malformed"] = float(bad)
        return out, bad
