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
moves the module there, and never probes for a card. It trains every
family of the zoo (the SSD's loss takes ``neg_pos_ratio`` and ``bg_push``,
passed to every step it builds; MobileNetV3's BatchNorm trains on batch
statistics and its eval epochs run on the running ones, which its
checkpoints carry).

Data parallelism (``config.data_parallel``, fdtpu's mesh step builders):
each rank of an initialised ``torch.distributed`` group of that size builds
its own Trainer on its own device, with loaders built with
``process_shard=(rank, world)``, and takes the data-parallel train and eval
steps (``fdtpu_torch/parallel/dp.py``) by the route fdtpu's Trainer takes
(``parallel.trainer_route``): shard_map's with ``rotate_device``,
``device_data`` or ``steps_per_dispatch`` > 1, GSPMD's otherwise, whose
BatchNorms (MobileNetV3's) normalise by the global batch's statistics. The
Trainer broadcasts rank 0's initial params and buffers; rank 0 writes the
logs, drawings and checkpoints, and every rank waits for each checkpoint
before it goes on; every rank reads the checkpoint on ``maybe_resume``.

Dispatch (fdtpu's jitted steps, its ``steps_per_dispatch`` scan and its
resident epoch scans, under ``shard_map`` too): the Trainer replays its
train step, its metrics step and its eval steps from CUDA graphs
(:meth:`Trainer.runner`, the one place that picks a batch's step;
``train/graphs.py``, with a capturable Adam, the graphs in one memory
pool) wherever the card can (:meth:`Trainer.replays`): on a card, without
``nan_check``, and with no data-parallel group or an NCCL one, whose
collectives the graphs capture. Both drivers replay them for every batch. The eager steps run on the CPU,
under ``nan_check`` (anomaly mode checks each backward on the host) and
over a gloo group (its collectives run on the host): a rule of the
configuration, not a fallback on failure. ``steps_per_dispatch`` sets the
streamed feed's group log cadence, fdtpu's, whichever step runs.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
import torch.distributed as dist

from fdtpu_torch.data.pipeline import BatchLoader
from fdtpu_torch.parallel.dp import barrier, broadcast_module, trainer_route
from fdtpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from fdtpu_torch.train.drivers import make_driver
from fdtpu_torch.train.graphs import CapturedEvalStep, CapturedTrainStep
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

        self.group = self._data_parallel_group(config, train_loader, val_loader)
        self.rank = dist.get_rank(self.group) if self.group is not None else 0
        self.world = dist.get_world_size(self.group) if self.group is not None else 1
        self.primary = self.rank == 0  # writes logs, drawings and checkpoints

        replays = self.replays(self.device, config, self.group)
        self.state = create_train_state(
            self.module, config, steps_per_epoch=max(len(train_loader), 1), capturable=replays)
        if self.group is not None:
            broadcast_module(self.module, self.group)  # every rank starts from rank 0's
        self._augment = augment
        self._nms_params = nms_params
        # the SSD loss's knobs, the same for every step (train/val objectives aligned)
        self._loss_kw = dict(neg_pos_ratio=neg_pos_ratio, bg_push=bg_push)
        self.route = trainer_route(config)  # fdtpu's choice of DP step builder
        self._train_step_metrics = None  # built on first use
        self.train_step = make_train_step(
            self.module, config, augment=augment, compute_metrics=False, nms_params=nms_params,
            group=self.group, route=self.route, **self._loss_kw)
        # where the card can, every step a replay of its CUDA graph (runner),
        # each captured at its first call, all in one memory pool
        self.replaying = replays
        self.graph_pool = torch.cuda.graph_pool_handle() if replays else None
        self.captured: dict[str, CapturedTrainStep | CapturedEvalStep] = {}  # slot -> graph
        self.build_eval_steps()
        self.epoch = 0
        self.profile_dir: str | None = None  # set to trace the next train epoch
        # feed mode (streamed / resident) -> one driver
        self.driver = make_driver(self)

    def build_eval_steps(self) -> None:
        """The eval steps of :attr:`module`: :attr:`eval_step` (over the
        group) and :attr:`local_eval_step` (the first-batch drawings: rank
        0's own rows, no collective). Called again after :attr:`module` is
        rebound, which drops their graphs: a graph reads the params of the
        module it captured."""
        kw = dict(nms_params=self._nms_params, return_boxes=True, **self._loss_kw)
        self.eval_step = make_eval_step(self.module, group=self.group, **kw)
        self.local_eval_step = self.eval_step if self.group is None else make_eval_step(
            self.module, **kw)
        for slot in ("eval", "local_eval"):
            self.captured.pop(slot, None)

    def runner(self, slot: str):
        """The step a batch of ``slot`` runs: ``"train"``, ``"metrics"``
        (an epoch's last train batch with ``train_metrics``), ``"eval"`` or
        ``"local_eval"`` (:attr:`local_eval_step`). Where the Trainer
        replays (:attr:`replaying`), the replay of the step's CUDA graph,
        kept in :attr:`captured` by slot and captured at its first call;
        the eager step otherwise."""
        eager = (self._metrics_train_step() if slot == "metrics"
                 else getattr(self, f"{slot}_step"))
        if not self.replaying:
            return eager
        if slot == "local_eval" and self.group is None:
            slot = "eval"  # the same step
        if slot not in self.captured:
            kind = CapturedEvalStep if slot.endswith("eval") else CapturedTrainStep
            self.captured[slot] = kind(eager, self.graph_pool)
        return self.captured[slot]

    @staticmethod
    def replays(device: torch.device, config: TrainConfig, group) -> bool:
        """Whether the Trainer replays its train, metrics and eval steps
        from CUDA graphs: on a card, without ``nan_check``, over no group
        or an NCCL one."""
        return (device.type == "cuda" and not config.nan_check
                and (group is None or dist.get_backend(group) == "nccl"))

    @staticmethod
    def _data_parallel_group(config: TrainConfig, train_loader, val_loader):
        """The process group of ``config.data_parallel`` ranks (fdtpu's
        mesh), or None for one process. -1 is the default group's size (one
        process without a group). The global batch must divide among the
        ranks, the default group must have that many, and each loader must
        give this rank its slice (``process_shard``)."""
        n = config.data_parallel
        if n == -1:
            n = dist.get_world_size() if dist.is_initialized() else 1
        if n in (None, 0, 1):
            return None
        if train_loader.batch_size % n:
            raise ValueError(f"data_parallel={n} requires batch_size divisible by the number of "
                             f"ranks (got batch_size={train_loader.batch_size})")
        if not dist.is_initialized() or dist.get_world_size() != n:
            raise ValueError(f"data_parallel={n} needs an initialised process group of {n} ranks "
                             "(fdtpu_torch.parallel.initialize_multihost)")
        shard = (dist.get_rank(), n)
        for loader in (train_loader, val_loader):
            if loader is not None and getattr(loader, "process_shard", None) != shard:
                raise ValueError(f"data_parallel={n}: build each loader with "
                                 f"process_shard={shard} on this rank")
        return dist.group.WORLD

    def _metrics_train_step(self):
        """Train step that also decodes predictions (K1) and computes the
        reference's detection metrics (``ModelMeta.py:258-287``); used on
        the final batch of each epoch only."""
        if self._train_step_metrics is None:
            self._train_step_metrics = make_train_step(
                self.module, self.config, augment=self._augment, compute_metrics=True,
                nms_params=self._nms_params, group=self.group, route=self.route,
                **self._loss_kw)
        return self._train_step_metrics

    def profile(self, trace_dir: str = "profiles"):
        """Trace the next training epoch with ``torch.profiler`` (host ops,
        and the card's kernels on a CUDA device) into
        ``<trace_dir>/train_epoch_<N>.json``, a Chrome/Perfetto trace."""
        self.profile_dir = trace_dir
        return self

    # -- checkpointing -------------------------------------------------------

    def save(self) -> Path:
        """Write the state's checkpoint (rank 0; every rank waits for it)
        and return its path."""
        ckpt_dir = Path(self.config.checkpoint_dir) / self.run_name
        if self.primary:
            path = save_checkpoint(ckpt_dir, self.state)
        else:
            path = checkpoint_path(ckpt_dir, int(self.state.step))
        if self.group is not None:
            barrier(self.group, self.device)
        return path

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
