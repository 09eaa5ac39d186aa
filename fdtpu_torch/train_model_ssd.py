"""SSD detector training, the port's ``train_model_ssd.py``.

    python -m fdtpu_torch.train_model_ssd --data-dir DIR [--device cuda]

The same flags and defaults as ``train_model_ssd.py``: SSD-16 @480px (4774
priors), batch 24, lr 1e-4, 70 epochs, neg:pos 10, SAM + Adam, bf16
compute with float32 params, augmentation off (the reference SSD pipeline
trains with a resize only), quarter-epochs (``epoch_fraction=4``: each
epoch is a fresh quarter of the train split), the crowding filter < 120
faces and 128 boxes an image; plus ``--device`` (default ``cuda``; ``cpu``
only when asked). ``--device-data`` stages the train split on the card
(the resident driver, which slices each quarter-epoch off a fresh full
permutation). Logs go to ``logs/out_<run>.log`` (+ ``.jsonl``,
``logs/tb/``), checkpoints to ``checkpoints/<run>/step_*.pt``.

``--data-parallel N`` and ``--multihost`` as in ``fdtpu_torch.train_model``
(fdtpu's SSD entry point has ``--data-parallel`` only; the port gives it
both), and ``--steps-per-dispatch K``: fdtpu's groups of K streamed
batches, the log cadence (on a card every batch replays the step
captured in a CUDA graph, the metrics and val batches theirs, whatever K;
one process only for K > 1). Left out, as there: ``--platform`` (``--device`` names the device).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from fdtpu_torch.data import (
    BatchLoader,
    WIDERFaceDataSource,
    download_dataset_files,
    load_targets,
)
from fdtpu_torch.models import DTYPES, build_model, ssd_patch_sizes
from fdtpu_torch.parallel.multihost import (
    entry_process_shard,
    join_entry_rank,
    shutdown,
    start_entry_ranks,
)
from fdtpu_torch.train import Trainer
from fdtpu_torch.train.checkpoint import latest_checkpoint
from fdtpu_torch.utils.config import SSDConfig, TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="data", help="WIDERFace root")
    p.add_argument("--input", type=int, default=480, help="square input size")
    p.add_argument("--filters", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--epochs", type=int, default=70, help="quarter-epochs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--neg-pos-ratio", type=int, default=10)
    p.add_argument("--bg-push", type=float, default=0.0,
                   help="opt-in quality extension (not in the reference): weight on the BCE "
                        "of unmined background priors; 0.0 is the reference loss")
    p.add_argument("--no-sam", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="device augmentation (the reference SSD pipeline trains with a "
                        "resize only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--box-capacity", type=int, default=128)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-train-images", type=int, default=0,
                   help="subset for quick runs (0 = all)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps a dispatch (see fdtpu_torch.train_model)")
    p.add_argument("--device-data", action="store_true",
                   help="stage the training set on the device once; each quarter-epoch is "
                        "drawn there from a fresh permutation")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="ranks (0 = one process, -1 = torchrun's world size or every visible "
                        "card); the batch size must divide")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun describes; implies "
                        "--data-parallel -1")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def run_name(args) -> str:
    return f"ssd_{args.filters}_{args.input}x{args.input}"


def build_trainer(args) -> Trainer:
    """The data, the model and the Trainer that ``main`` fits, from parsed
    flags."""
    name = run_name(args)
    shape = (args.input, args.input)
    cfg = SSDConfig(
        filters=args.filters,
        input_shape=shape,
        patch_sizes=ssd_patch_sizes(shape),
        neg_pos_ratio=args.neg_pos_ratio,
        bg_push=args.bg_push,
    )
    train_cfg = TrainConfig(
        learning_rate=args.lr,
        max_epochs=args.epochs,
        batch_size=args.batch_size,
        box_capacity=args.box_capacity,
        use_sam=not args.no_sam,
        seed=args.seed,
        log_path=f"logs/out_{name}.log",
        checkpoint_dir="checkpoints",
        device_data=args.device_data,
        data_parallel=args.data_parallel,
        steps_per_dispatch=args.steps_per_dispatch,
    )

    download_dataset_files(args.data_dir)
    train_targets = load_targets(args.data_dir, "train", max_faces=120)
    val_targets = load_targets(args.data_dir, "val", max_faces=120)
    if args.max_train_images:
        train_targets = train_targets[: args.max_train_images]
        val_targets = val_targets[: max(args.max_train_images // 4, 1)]

    train_src = WIDERFaceDataSource(train_targets, shape, args.box_capacity, seed=args.seed)
    val_src = WIDERFaceDataSource(val_targets, shape, args.box_capacity)
    shard = entry_process_shard(args)
    train_loader = BatchLoader(train_src, args.batch_size, shuffle=True, seed=args.seed,
                               drop_last=True, epoch_fraction=4, process_shard=shard)
    val_loader = BatchLoader(val_src, args.batch_size, process_shard=shard)

    module = build_model("ssd", cfg, args.device, torch.Generator().manual_seed(args.seed),
                         compute_dtype=DTYPES[cfg.dtype])
    return Trainer(
        module, train_cfg, train_loader, val_loader,
        augment=args.augment, run_name=name, device=args.device,
        neg_pos_ratio=cfg.neg_pos_ratio, bg_push=cfg.bg_push,
    )


def train(args):
    """Trains (resuming with ``--resume``), saves, and returns the last
    checkpoint's path."""
    trainer = build_trainer(args)
    if args.resume:
        trainer.maybe_resume()
    out = trainer.fit()
    ckpt = trainer.save()
    if trainer.primary:
        print(f"final: {out}")
        print(f"saved: {ckpt}")
    return ckpt


def _rank_main(rank: int, world: int, init_method: str, argv) -> None:
    """One of the ranks ``--data-parallel N`` launches."""
    args = parse_args(argv)
    join_entry_rank(args, rank, world, init_method)
    try:
        train(args)
    finally:
        shutdown()


def main(argv=None):
    """Trains, saves, and returns the last checkpoint's path (rank 0's
    under data parallelism)."""
    args = parse_args(argv)
    if not start_entry_ranks(args, _rank_main, argv):
        return latest_checkpoint(Path("checkpoints") / run_name(args))
    try:
        return train(args)
    finally:
        shutdown()  # the group torchrun's ranks joined, if any


if __name__ == "__main__":
    main()
