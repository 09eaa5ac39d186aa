"""Epoch training loop (``fdtpu/train/loop.py``), the counterpart of the
reference's ``pytorch_lightning.Trainer`` + ``ModelMeta``.

* fit over N epochs with per-epoch validation;
* per-epoch metric aggregation + F1 and console/file/JSONL/TensorBoard
  logging (``ModelMeta.py:241-313``);
* first-batch visualization to ``imgs/{train,validation}_epoch_N.png``
  (``ModelMeta.py:144-157``);
* a checkpoint after every epoch, and resume;
* the MultiStep learning rate comes from the train state's schedule.

The Trainer owns configuration, the train state, step construction,
checkpointing and the fit loop; the per-feed-mode epoch bodies (streamed,
device-resident) live in :mod:`fdtpu_torch.train.drivers`. It runs on the
``device`` it is given (default ``"cuda"``; the CPU only when asked),
moves the module there, and never probes for a card. It trains PoolResnet
and the SSD (whose loss takes ``neg_pos_ratio`` and ``bg_push``, passed to
every step it builds); fdtpu's data-parallel step builders are not ported
(ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from fdtpu_torch.data.pipeline import BatchLoader
from fdtpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from fdtpu_torch.train.drivers import make_driver
from fdtpu_torch.train.state import create_train_state
from fdtpu_torch.train.step import make_eval_step, make_train_step
from fdtpu_torch.utils.config import TrainConfig
from fdtpu_torch.utils.logging import MetricLogger


class Trainer:
    def __init__(
        self,
        module,
        config: TrainConfig,
        train_loader: BatchLoader,
        val_loader: BatchLoader | None = None,
        augment: bool = True,
        nms_params: tuple[float, float, int] = (0.5, 0.5, 64),
        run_name: str = "run",
        device: torch.device | str = "cuda",
        neg_pos_ratio: int = 10,
        bg_push: float = 0.0,
    ):
        self.device = torch.device(device)
        self.module = module.to(self.device)
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.run_name = run_name
        self.logger = MetricLogger(config.log_path)
        if config.nan_check:
            # fdtpu sets jax_debug_nans, which checks the output of every
            # primitive, forward and backward, and re-runs the failing one
            # un-jitted. Autograd's anomaly mode checks only the backward: a
            # backward function that returns NaN raises, with the traceback
            # of the forward op that made it. A NaN in the forward values, the
            # loss or the optimizer update is not caught by itself. It is
            # process-wide and slows every backward.
            torch.autograd.set_detect_anomaly(True)
        if config.positional_crop is None:
            # auto: positional crop is distribution-identical exactly when
            # batch composition re-randomizes per epoch (see
            # augment_batch_fast); resolve from the feed's shuffle flag.
            config = dataclasses.replace(
                config, positional_crop=bool(getattr(train_loader, "shuffle", False)))
            self.config = config

        self.state = create_train_state(
            self.module, config, steps_per_epoch=max(len(train_loader), 1))
        self._augment = augment
        self._nms_params = nms_params
        # the SSD loss's knobs, the same for every step (train/val objectives aligned)
        self._loss_kw = dict(neg_pos_ratio=neg_pos_ratio, bg_push=bg_push)
        self._train_step_metrics = None  # built on first use
        self.train_step = make_train_step(
            self.module, config, augment=augment, compute_metrics=False, nms_params=nms_params,
            **self._loss_kw)
        self.eval_step = make_eval_step(self.module, nms_params=nms_params, return_boxes=True,
                                        **self._loss_kw)
        self.epoch = 0
        self.profile_dir: str | None = None  # set to trace the next train epoch
        # feed mode (streamed / resident) -> one driver
        self.driver = make_driver(self)

    def _metrics_train_step(self):
        """Train step that also decodes predictions (K1) and computes the
        reference's detection metrics (``ModelMeta.py:258-287``); used on
        the final batch of each epoch only."""
        if self._train_step_metrics is None:
            self._train_step_metrics = make_train_step(
                self.module, self.config, augment=self._augment, compute_metrics=True,
                nms_params=self._nms_params, **self._loss_kw)
        return self._train_step_metrics

    def profile(self, trace_dir: str = "profiles"):
        """Trace the next training epoch with ``torch.profiler`` (host ops,
        and the card's kernels on a CUDA device) into
        ``<trace_dir>/train_epoch_<N>.json``, a Chrome/Perfetto trace."""
        self.profile_dir = trace_dir
        return self

    # -- checkpointing -------------------------------------------------------

    def save(self) -> Path:
        return save_checkpoint(Path(self.config.checkpoint_dir) / self.run_name, self.state)

    def maybe_resume(self) -> bool:
        path = latest_checkpoint(Path(self.config.checkpoint_dir) / self.run_name)
        if path is None:
            return False
        self.state = restore_checkpoint(path, self.state)
        self.epoch = int(self.state.step) // max(len(self.train_loader), 1)
        # a shuffled BatchLoader draws each epoch's order from its own epoch
        # count: set it to the resumed epoch, so that the run continues bit
        # for bit (fdtpu leaves it at 0 and repeats the first orders)
        if hasattr(self.train_loader, "_epoch"):
            self.train_loader._epoch = self.epoch
        return True

    # -- epochs --------------------------------------------------------------

    def train_epoch(self) -> dict:
        if self.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                metrics = self.driver.train_epoch()
            out = Path(self.profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / f"train_epoch_{self.epoch}.json"))
            self.profile_dir = None
            return metrics
        return self.driver.train_epoch()

    def eval_epoch(self, loader: BatchLoader | None = None, split="validation") -> dict:
        loader = loader or self.val_loader
        if loader is None:
            return {}
        return self.driver.eval_epoch(loader, split)

    def fit(self, epochs: int | None = None) -> dict:
        epochs = self.config.max_epochs if epochs is None else epochs
        last: dict = {}
        while self.epoch < epochs:
            train_metrics = self.train_epoch()
            val_metrics = self.eval_epoch()
            self.epoch += 1
            self.save()
            last = {"train": train_metrics, "val": val_metrics}
        return last

    def test(self, loader: BatchLoader) -> dict:
        """``trainer.test`` equivalent (``run_validation_epoch.py:68-69``)."""
        return self.eval_epoch(loader, split="test")
