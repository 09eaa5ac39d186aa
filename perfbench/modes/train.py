"""The ``train`` mode: resident training through the program's Trainer,
``train_model --device-data``'s path (``train_model_ssd``'s for the SSD),
with the family's loss arguments (``programs/<family>.py``).

Set-up makes the dataset (``data.faces``, the configuration's
``train_images`` at its input size, on the card, then on the host, where
the program's source serves it) and the weights from the seed, builds
the program's Trainer over an in-memory source, which the program stages
resident on the card (``TrainConfig.device_data``), shuffled, SAM + Adam at the
configuration's rate, augmentation and rotation as the configuration
says, the epoch's last batch through the metrics step, no drawings, no
checkpoints, its log under the run's scratch directory. It then runs one
epoch: the Trainer captures its train and metrics steps' CUDA graphs at
their first calls, and the epoch's first steps are the ones checked: after
the first the benchmark copies Adam's first moments, after the third the
parameters. Where the step rotates on the card, the shear kernels' launch
arguments are read as the program makes them in that epoch: the planes
each launch moves, which ``shear_roofline`` divides by.

The measured window runs whole epochs (``Trainer.train_epoch``, each
ending in the host's read of its losses) until ``seconds`` have passed;
``train_img_s`` is the images of every step over the window's length,
which ends in ``torch.cuda.synchronize``. The traced window is the last
``trace_steps`` steps of an epoch (the whole epoch where it is shorter) and
the epoch's end under the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import data, judge, program, reference, weights
from perfbench.reference.train import follow
from perfbench.roofline import flops
from perfbench.trace import Tracer

SHEAR_ENTRIES = ("fdtpu_shear_rows", "fdtpu_shear_cols")


@contextlib.contextmanager
def watching(trainer, after):
    """Calls ``after(state, scalars, rows)`` after each train and metrics
    step the Trainer takes."""
    runner = trainer.runner

    class Watched:
        def __init__(self, step):
            self.step = step

        def __call__(self, state, *batch):
            state, scalars = self.step(state, *batch)
            after(state, scalars)
            return state, scalars

        def gather(self, state, data_, rows):
            state, scalars = self.step.gather(state, data_, rows)
            after(state, scalars, rows)
            return state, scalars

    trainer.runner = lambda slot: Watched(runner(slot)) if slot in ("train", "metrics") \
        else runner(slot)
    try:
        yield
    finally:
        del trainer.runner


@contextlib.contextmanager
def shear_launches(device):
    """-> the elements and item size of each shear launch the program
    makes inside the block (its kernel library's entries, read by their
    arguments: ``(K, R, L)`` planes, bfloat16 or float32)."""
    seen: list[tuple[int, int]] = []
    if device.type != "cuda":
        yield seen
        return
    from fdtpu_torch.kernels import build

    lib = build.load_library()
    saved = {name: getattr(lib, name) for name in SHEAR_ENTRIES}

    def observed(entry):
        def call(src, dst, k, bf16, kk, r, l, *rest):
            seen.append((kk * r * l, 2 if bf16 else 4))
            return entry(src, dst, k, bf16, kk, r, l, *rest)
        return call

    for name, entry in saved.items():
        setattr(lib, name, observed(entry))
    try:
        yield seen
    finally:
        for name, entry in saved.items():
            setattr(lib, name, entry)


class Recorder:
    """Called after each step of the first epoch (:func:`watching`), keeps
    what the check reads of the program's state after its first steps:
    the reported losses, the rows (where the step gathers them), Adam's
    first moments after the first step and the parameters after the
    last checked one."""

    def __init__(self, steps: int):
        self.steps = steps
        self.losses: list[float] = []
        self.rows: list = []
        self.first_moment: dict = {}
        self.params: dict = {}

    def __call__(self, state, scalars, rows=None) -> None:
        n = len(self.losses) + 1
        if n > self.steps:
            return
        self.losses.append(float(scalars["loss"]))
        self.rows.append(None if rows is None else rows.clone())
        named = dict(state.module.named_parameters())
        if n == 1:
            opt = state.optimizer
            self.beta1 = opt.param_groups[0]["betas"][0]
            self.first_moment = {k: opt.state[p]["exp_avg"].detach().clone()
                                 for k, p in named.items()}
        if n == self.steps:
            self.params = {k: p.detach().clone() for k, p in named.items()}


class Cell:
    """One train cell: ``setup``, ``window`` or ``traced``, ``release``,
    ``check`` (``perfbench/cell.py`` calls them in that order)."""

    def __init__(self, name: str, config: dict, mix: dict, seed: int, device: torch.device,
                 workdir: Path):
        self.name, self.config, self.mix, self.seed = name, config, mix, seed
        self.device, self.workdir = device, workdir
        self.train = config["train"]
        self.batch = self.train["batch_size"]

    def _epoch(self) -> dict:
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            metrics = self.trainer.train_epoch()
        self.trainer.epoch += 1
        return metrics

    def setup(self) -> None:
        from fdtpu_torch.data import BatchLoader
        from fdtpu_torch.train import Trainer
        from fdtpu_torch.utils.config import TrainConfig

        c, t, m = self.config, self.train, self.config["model"]
        made = data.faces(self.seed, "train", c["train_images"], m["input_shape"][0],
                          t["box_capacity"], self.mix["faces_mean"], self.device)
        self.host = tuple(x.cpu().numpy() for x in made)  # the program stages from the host
        del made
        ref = reference.family(c["reference"])
        self.weights = weights.draw(ref.param_specs(m), self.seed, self.device)
        net = program.module(c, self.weights, self.device, train=True)
        loader = BatchLoader(data.ArraySource(*self.host), self.batch,
                             shuffle=self.mix["shuffle"], seed=self.seed, drop_last=True,
                             epoch_fraction=t["epoch_fraction"])
        tcfg = TrainConfig(learning_rate=t["learning_rate"], optimizer=t["optimizer"],
                           batch_size=self.batch, box_capacity=t["box_capacity"],
                           sam_rho=t["sam_rho"], seed=self.seed,
                           log_path=str(self.workdir / f"{self.name}.log"),
                           visualize_first_batch=False,
                           train_metrics=self.mix["train_metrics"], device_data=True,
                           rotate_device=t["rotate_device"])
        self.trainer = Trainer(net, tcfg, loader, None, augment=t["augment"],
                               run_name=self.name, device=self.device,
                               **program.family(c).loss_kwargs(c))
        self.steps_per_epoch = len(loader)
        self.recorder = Recorder(self.mix["check_steps"])
        rotating = t["augment"] and t["rotate_device"]
        with watching(self.trainer, self.recorder), \
                shear_launches(self.device if rotating else torch.device("cpu")) as seen:
            self._epoch()
        self.shear_launches = seen

    def window(self, seconds: float) -> tuple[float, dict, int, int]:
        """-> ``(start, end-to-end metrics, steps, failed steps)``."""
        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            loss = self._epoch()["loss"]
            steps += self.steps_per_epoch
            failed += 0 if math.isfinite(loss) else self.steps_per_epoch
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        return t0, {"train_img_s": steps * self.batch / window_s}, steps, failed

    def traced(self):
        """-> ``(Window, steps, failed steps)``: the profiler starts after
        the epoch's step ``steps_per_epoch - trace_steps``."""
        tracer = Tracer(self.device)
        skip = max(0, self.steps_per_epoch - self.mix["trace_steps"])
        taken = [0]

        def after(state, scalars, rows=None):
            taken[0] += 1
            if taken[0] == skip:
                tracer.start()

        if skip == 0:
            tracer.start()
        with watching(self.trainer, after):
            loss = self._epoch()["loss"]
        window = tracer.stop()
        steps = self.steps_per_epoch - skip
        return window, steps, 0 if math.isfinite(loss) else steps

    def layer_context(self) -> dict:
        m, t = self.config["model"], self.train
        return {"mode": "train", "images_per_unit": self.batch,
                "flops_per_image": flops.train_step_flops(self.config["reference"], m),
                "shear_launches": self.shear_launches}

    def release(self) -> None:
        """Keep what the check reads of the program's first steps, then
        free the program."""
        r = self.recorder
        self.program_out = {
            "losses": r.losses, "rows": r.rows,
            "first_grad": {k: v / (1.0 - r.beta1) for k, v in r.first_moment.items()},
            "change": {k: v - self.weights[k] for k, v in r.params.items()},
        }
        del self.trainer, self.recorder
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """The reference follows the checked steps; -> ``(numbers, failed
        units)``."""
        ref = reference.family(self.config["reference"])
        dataset = tuple(torch.from_numpy(x) for x in self.host)
        with reference.strict_float32():
            out = follow(ref, self.config["model"], self.train, self.weights, dataset, self.seed,
                         self.mix["check_steps"])
        rows = [r for r in self.program_out["rows"] if r is not None]
        if rows and not all(torch.equal(a, b) for a, b in zip(rows, out["rows"])):
            print("check: the program's rows differ from the reference's row order",
                  file=sys.stderr)
        self.details = judge.train_details(self.program_out, out)
        rows = ref.box_rows(self.config["model"])
        return judge.train_numbers(self.program_out, out, rows), 0
