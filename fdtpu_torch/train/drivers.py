"""Per-feed-mode epoch drivers for the Trainer (``fdtpu/train/drivers.py``).

* :class:`StreamedDriver` — per-batch host -> device streaming through
  :class:`~fdtpu_torch.data.pipeline.DevicePrefetcher`, one train step a
  batch: on a card a replay of the Trainer's captured step (a CUDA graph,
  ``train/graphs.py``), the metrics step's and the eval step's too;
  ``steps_per_dispatch`` sets fdtpu's group log cadence (its
  ``ScanDispatchDriver``).
* :class:`ResidentDriver` — ``device_data``: the dataset staged once on the
  device as ``(N, H, W, 3)`` u8 tensors plus boxes and masks; each epoch is
  a permutation on the device and batches are gathered by index. Where the
  Trainer replays, every batch replays its captured step (the metrics one
  too), which gathers its rows inside the graph, so the epoch has one host
  sync, at its end, as fdtpu's epoch is one device program; it prints no
  step line, as fdtpu's epoch scan prints none. The eval epoch replays the
  captured eval step the same way, fdtpu's eval scan.

Drivers read and write training state through the owning ``Trainer``
(``state``, ``epoch``, each batch's step by ``runner``, ``replaying``,
``config``, ``device``, and ``rank``/``world`` under data parallelism);
the Trainer keeps checkpointing, step construction, logging and the fit
loop.

Under ``data_parallel`` every rank runs the same driver on its slice of
each global batch, through the data-parallel steps (their reductions make
the state, the losses and the metrics the same on every rank): streamed, the
rank's ``BatchLoader(process_shard=...)``; resident, the rank stages its
slice of every global batch (fdtpu's ``_stage_from_source_multihost``) and
draws its own real-first permutation of it each epoch (fdtpu's
``_device_epoch_sharded``: a stratified shuffle, every global batch taking
``B / world`` rows from each rank's pool). Only rank 0 draws. Over an NCCL
group on the cards every rank replays its captured data-parallel steps, as
fdtpu scans its ``shard_map``'d steps: streamed (fdtpu's
``ScanDispatchDriver`` under ``shard_map``, with its group log cadence) and
resident, where each rank's graph gathers its rows by its own permutation.
Over gloo the data-parallel steps run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtpu_torch.data.pipeline import DevicePrefetcher
from fdtpu_torch.train.metrics import f1_score
from fdtpu_torch.train.step import step_seed
from fdtpu_torch.utils.draw import draw_bbx

DETECTION_KEYS = ("iou", "recall", "precision")


def _epoch_perm(gen: torch.Generator, sample_mask: torch.Tensor, shuffle: bool) -> torch.Tensor:
    """Permutation with every REAL row before every padded row (random
    among real rows when shuffling, source order otherwise), so truncating
    to ``nb * batch`` rows drops pads first and the dropped real samples
    rotate with the epoch's generator."""
    n = sample_mask.shape[0]
    if shuffle:
        scores = torch.where(
            sample_mask,
            torch.rand((n,), generator=gen, device=sample_mask.device),
            2.0,
        )
    else:
        ar = torch.arange(n, dtype=torch.float32, device=sample_mask.device)
        scores = torch.where(sample_mask, ar, ar + n)
    return torch.argsort(scores, stable=True)


def _mean(values: list) -> float:
    """The mean of a list of 0-d tensors, on the host in float32 (one
    device sync), the same reduction in every driver."""
    return float(np.mean(torch.stack(values).float().cpu().numpy()))


def _finalize_train_metrics(trainer, losses, det_metrics: dict) -> dict:
    """Shared per-epoch metric assembly + logging (one device sync). The
    metric names come in sorted order, then ``f1``, as fdtpu logs them
    (its step's scalars come back from ``jit`` as a pytree, keys sorted)."""
    metrics = {"loss": _mean(losses)}
    if det_metrics:
        metrics.update({k: float(v) for k, v in sorted(det_metrics.items())})
        metrics["f1"] = f1_score(metrics["precision"], metrics["recall"])
    trainer.logger.log_epoch(trainer.epoch, "training", metrics)
    return metrics


def _finalize_eval_metrics(trainer, agg: dict, split: str) -> dict:
    metrics = {k: _mean(v) for k, v in sorted(agg.items())}
    if "precision" in metrics and "recall" in metrics:
        metrics["f1"] = f1_score(metrics["precision"], metrics["recall"])
    trainer.logger.log_epoch(trainer.epoch, split, metrics)
    return metrics


class EpochDriver:
    """One feed mode's train/eval epoch bodies."""

    def __init__(self, trainer):
        self.t = trainer

    def train_epoch(self) -> dict:
        raise NotImplementedError

    def eval_epoch(self, loader, split: str) -> dict:
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------

    def _step(self, last: bool):
        """The metrics step on an epoch's final batch (with
        ``train_metrics``), the plain train step otherwise; each replayed
        where the Trainer replays."""
        t = self.t
        return t.runner("metrics" if last and t.config.train_metrics else "train")

    def _visualize_batch(self, batch_args, save_name: str):
        """Render sample 0's predictions (ModelMeta.py:144-157), on rank 0
        alone, through the eval step without collectives (replayed where the
        Trainer replays)."""
        t = self.t
        if not t.primary:
            return
        _, (pred_boxes, pred_mask) = t.runner("local_eval")(t.state, *batch_args)
        draw_bbx(batch_args[0][0].cpu().numpy(), pred_boxes[0].cpu().numpy(),
                 mask=pred_mask[0].cpu().numpy(), save_name=save_name)


class StreamedDriver(EpochDriver):
    """Per-batch streaming feed (host decode -> prefetch -> one train step a
    batch); eval has the same shape.

    Where the Trainer replays (``Trainer.replays``) every batch replays its
    captured step (``t.runner``, a CUDA graph: ``train/graphs.py``; the
    metrics batch its own), as fdtpu runs one compiled dispatch a batch; on
    the CPU, with ``nan_check`` or over gloo the eager steps run.
    ``steps_per_dispatch`` = k sets the log cadence alone (fdtpu's
    ``ScanDispatchDriver`` for k > 1): the batches go in fdtpu's groups of
    k, one log line (a host sync) at the last step of every
    ``log_every_steps // k``-th group. The final batch is the metrics
    step's when ``train_metrics`` is on, a group of its own at k = 1
    (fdtpu's per-batch loop) and of no group for k > 1. A replay copies its
    batch into the graph's buffers, so no batch waits for its group."""

    def train_epoch(self) -> dict:
        t = self.t
        k = t.config.steps_per_dispatch
        losses = []
        det_metrics: dict = {}
        nb = len(t.train_loader)
        grouped = nb - (1 if t.config.train_metrics and nb else 0)  # fdtpu's group_target
        every = t.config.log_every_steps
        log_groups = max(1, every // k) if every else 0
        for bi, batch in enumerate(DevicePrefetcher(t.train_loader, t.device)):
            args = (batch.images, batch.boxes, batch.box_mask, batch.sample_mask)
            if bi == 0 and t.config.visualize_first_batch:
                self._visualize_batch(args, f"train_epoch_{t.epoch}")
            t.state, scalars = self._step(bi >= grouped)(t.state, *args)
            if bi >= grouped:
                det_metrics = {key: scalars[key] for key in DETECTION_KEYS}
            losses.append(scalars["loss"])
            ends_group = (bi < grouped or k == 1) and ((bi + 1) % k == 0 or bi == grouped - 1)
            if log_groups and t.primary and ends_group and (bi // k) % log_groups == 0:
                print(f"epoch {t.epoch} step {bi}: step_loss={float(scalars['loss']):.4f}",
                      flush=True)
        return _finalize_train_metrics(t, losses, det_metrics)

    def eval_epoch(self, loader, split: str) -> dict:
        """One eval step a batch, replayed from its CUDA graph where the
        Trainer replays (a smaller last batch is a graph of its own)."""
        t = self.t
        step = t.runner("eval")
        agg: dict[str, list] = {}
        first = True
        for batch in DevicePrefetcher(loader, t.device):
            scalars, (pred_boxes, pred_mask) = step(
                t.state, batch.images, batch.boxes, batch.box_mask, batch.sample_mask)
            for k, v in scalars.items():
                agg.setdefault(k, []).append(v)
            if first and t.config.visualize_first_batch and t.primary:
                # ModelMeta.py:144-157: render the first sample's predictions
                draw_bbx(batch.images[0].cpu().numpy(), pred_boxes[0].cpu().numpy(),
                         mask=pred_mask[0].cpu().numpy(), save_name=f"{split}_epoch_{t.epoch}")
                first = False
        return _finalize_eval_metrics(t, agg, split)


class ResidentDriver(EpochDriver):
    """``device_data``: datasets resident on the device, train and eval."""

    def __init__(self, trainer):
        super().__init__(trainer)
        self._device_ds = None
        # keyed by the loader object (a strong ref keeps ids stable and the
        # staged tensors alive for the Trainer's lifetime)
        self._device_val: dict[object, tuple] = {}

    # -- staging -----------------------------------------------------------

    def _stage_device_dataset(self):
        if self._device_ds is None:
            src = self.t.train_loader.source
            if getattr(src, "rotate_prob", 0.0):
                raise ValueError(
                    "device_data stages decoded frames once, so host-side "
                    "rotation would freeze one angle per image for all "
                    "epochs. Build the source with rotate_prob=0.0 and use "
                    "rotate_device=True for rotation augmentation."
                )
            # all samples from the SOURCE, not the loader: an epoch_fraction
            # loader yields one random fraction a pass, while each resident
            # epoch slices its fraction off a fresh full-N permutation
            self._device_ds = self._stage_from_source(self.t.train_loader)
        return self._device_ds

    def _stage_from_source(self, loader):
        """Stage a loader's source as device tensors ``(N, ...)``.

        ALL ``n`` samples are staged, padded to whole batches with repeats
        of the last sample (masked via ``sample_mask``); the loader's
        ``drop_last``/``epoch_fraction`` truncation is applied per epoch
        after the permutation, so dropped samples rotate across epochs like
        the streamed ``BatchLoader._indices``. A data-parallel rank stages
        only its ``[rank * lb, (rank + 1) * lb)`` rows of every global
        batch (``lb = B / world``), the rows its ``process_shard`` feed
        yields. Copies go chunk by chunk from pinned memory."""
        t = self.t
        src = loader.source
        batch = loader.batch_size
        lb = batch // t.world
        rows = slice(t.rank * lb, (t.rank + 1) * lb)
        n = len(src)
        n_total = ((n + batch - 1) // batch) * batch
        dev = t.device
        parts: list[list] = [[], [], []]
        for start in range(0, n_total, batch):
            idx = np.minimum(np.arange(start, start + batch), n - 1)  # BatchLoader padding
            samples = (src.get_batch(idx[rows]) if hasattr(src, "get_batch")
                       else [src.get(int(i)) for i in idx[rows]])
            for i in range(3):
                host = torch.from_numpy(np.stack([s[i] for s in samples]))
                if dev.type == "cuda":
                    host = host.pin_memory()
                parts[i].append(host.to(dev, non_blocking=True))
        sample_mask = (torch.arange(n_total, device=dev) < n).view(-1, batch)[:, rows].reshape(-1)
        return (
            torch.cat(parts[0]),
            torch.cat(parts[1]).float(),
            torch.cat(parts[2]),
            sample_mask,
            n,
        )

    def _epoch_batches(self, loader, n_real: int) -> int:
        """Batches per resident epoch, matching ``BatchLoader.__len__``:
        ``epoch_fraction`` then ``drop_last``/``process_shard`` truncation
        (ceil otherwise: the padded tail rows sort last in the epoch
        permutation, so the final batch is exactly the streamed padded
        tail)."""
        batch = loader.batch_size
        ef = getattr(loader, "epoch_fraction", 1) or 1
        n_eff = n_real // ef
        if (bool(getattr(loader, "drop_last", False))
                or getattr(loader, "process_shard", None) is not None):
            return max(1, n_eff // batch)
        return max(1, (n_eff + batch - 1) // batch)

    # -- train -------------------------------------------------------------

    def train_epoch(self) -> dict:
        t = self.t
        imgs, boxes, bm, sm, n_real = self._stage_device_dataset()
        batch = t.train_loader.batch_size // t.world  # the rank's rows of each global batch
        nb = self._epoch_batches(t.train_loader, n_real)
        shuffle = bool(getattr(t.train_loader, "shuffle", False))
        rank = t.rank if t.group is not None else None  # each rank its own permutation
        gen = torch.Generator(device=t.device).manual_seed(
            step_seed(t.config.seed + 2, t.epoch, rank))
        perm = _epoch_perm(gen, sm, shuffle)

        def rows(i):
            sel = perm[i * batch : (i + 1) * batch]
            return imgs[sel], boxes[sel], bm[sel], sm[sel]

        if t.config.visualize_first_batch:
            self._visualize_batch(rows(0), f"train_epoch_{t.epoch}")
        losses = []
        data = (imgs, boxes, bm, sm)
        for i in range(nb):  # fdtpu's epoch scan: no step line (each would wait for the card)
            step = self._step(i == nb - 1)
            if t.replaying:  # the rows gathered inside the graph
                t.state, scalars = step.gather(t.state, data, perm[i * batch:(i + 1) * batch])
            else:
                t.state, scalars = step(t.state, *rows(i))
            losses.append(scalars["loss"])
        det = {k: scalars[k] for k in DETECTION_KEYS} if "iou" in scalars else {}
        return _finalize_train_metrics(t, losses, det)

    # -- eval --------------------------------------------------------------

    def eval_epoch(self, loader, split: str) -> dict:
        """Resident eval epoch over the staged loader's batches (contiguous
        slices, no permutation), honoring the loader's ``drop_last``: fdtpu's
        eval scan. Where the Trainer replays, each batch replays the captured
        eval step's gather form (its rows gathered inside the graph); the
        per-batch scalars stay on the card and the host reads their means
        once, at the epoch's end (fdtpu's ``v.mean()`` over the scan)."""
        t = self.t
        if loader not in self._device_val:
            self._device_val[loader] = self._stage_from_source(loader)
        imgs, boxes, bm, sm, n_real = self._device_val[loader]
        data = (imgs, boxes, bm, sm)
        batch = loader.batch_size // t.world
        index = torch.arange(imgs.shape[0], device=imgs.device)
        step = t.runner("eval")
        agg: dict[str, list] = {}
        for i in range(self._epoch_batches(loader, n_real)):
            sl = slice(i * batch, (i + 1) * batch)
            if t.replaying:
                out = step.gather(t.state, data, index[sl])
            else:
                out = step(t.state, *(x[sl] for x in data))
            scalars, (pred_boxes, pred_mask) = out
            for k, v in scalars.items():
                agg.setdefault(k, []).append(v)
            if i == 0 and t.config.visualize_first_batch and t.primary:
                draw_bbx(imgs[0].cpu().numpy(), pred_boxes[0].cpu().numpy(),
                         mask=pred_mask[0].cpu().numpy(), save_name=f"{split}_epoch_{t.epoch}")
        return _finalize_eval_metrics(t, agg, split)


def make_driver(trainer) -> EpochDriver:
    """Resolve the feed mode as fdtpu does: ``device_data`` wins, then the
    streamed feed, which takes ``steps_per_dispatch`` as its log cadence."""
    if trainer.config.device_data:
        return ResidentDriver(trainer)
    return StreamedDriver(trainer)
