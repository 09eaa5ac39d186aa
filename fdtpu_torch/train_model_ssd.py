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

Left out, as in ``fdtpu_torch.train_model``: ``--data-parallel`` (ROADMAP.md
queue 1, item 5), ``--steps-per-dispatch`` (it amortizes the TPU's dispatch
cost) and ``--platform`` (``--device`` names the device).
"""

from __future__ import annotations

import argparse

import torch

from fdtpu_torch.data import (
    BatchLoader,
    WIDERFaceDataSource,
    download_dataset_files,
    load_targets,
)
from fdtpu_torch.models import DTYPES, build_model, ssd_patch_sizes
from fdtpu_torch.train import Trainer
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
    p.add_argument("--device-data", action="store_true",
                   help="stage the training set on the device once; each quarter-epoch is "
                        "drawn there from a fresh permutation")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def build_trainer(args) -> Trainer:
    """The data, the model and the Trainer that ``main`` fits, from parsed
    flags."""
    run_name = f"ssd_{args.filters}_{args.input}x{args.input}"
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
        log_path=f"logs/out_{run_name}.log",
        checkpoint_dir="checkpoints",
        device_data=args.device_data,
    )

    download_dataset_files(args.data_dir)
    train_targets = load_targets(args.data_dir, "train", max_faces=120)
    val_targets = load_targets(args.data_dir, "val", max_faces=120)
    if args.max_train_images:
        train_targets = train_targets[: args.max_train_images]
        val_targets = val_targets[: max(args.max_train_images // 4, 1)]

    train_src = WIDERFaceDataSource(train_targets, shape, args.box_capacity, seed=args.seed)
    val_src = WIDERFaceDataSource(val_targets, shape, args.box_capacity)
    train_loader = BatchLoader(train_src, args.batch_size, shuffle=True, seed=args.seed,
                               drop_last=True, epoch_fraction=4)
    val_loader = BatchLoader(val_src, args.batch_size)

    module = build_model("ssd", cfg, args.device, torch.Generator().manual_seed(args.seed),
                         compute_dtype=DTYPES[cfg.dtype])
    return Trainer(
        module, train_cfg, train_loader, val_loader,
        augment=args.augment, run_name=run_name, device=args.device,
        neg_pos_ratio=cfg.neg_pos_ratio, bg_push=cfg.bg_push,
    )


def main(argv=None):
    """Trains, saves, and returns the last checkpoint's path."""
    args = parse_args(argv)
    trainer = build_trainer(args)
    if args.resume:
        trainer.maybe_resume()
    out = trainer.fit()
    print(f"final: {out}")
    ckpt = trainer.save()
    print(f"saved: {ckpt}")
    return ckpt


if __name__ == "__main__":
    main()
