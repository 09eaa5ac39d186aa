"""YOLO-grid detector training, the port's ``train_model.py``.

    python -m fdtpu_torch.train_model --data-dir DIR [--device cuda]

The same flags and defaults as ``train_model.py`` for what is ported:
PoolResnet-128 @480px, 10x10 grid, 10 blocks, batch 8, lr 1e-4, 70 epochs,
SAM + Adam, MultiStepLR@40 x0.1, bf16 compute with float32 params; plus
``--device`` (default ``cuda``; ``cpu`` only when asked). Logs go to
``logs/out_<run>.log`` (+ ``.jsonl``, ``logs/tb/``), checkpoints to
``checkpoints/<run>/step_*.pt``, both under the working directory.

Left out, with their ROADMAP.md queue-1 items: ``--data-parallel`` and
``--multihost`` (item 5, data parallelism), ``--steps-per-dispatch`` (not
ported by design: it amortizes the TPU's dispatch cost), and
``--pretrained-backbone`` (item 4, MobileNetV3 and the TorchScript import);
``--no-fast-stem`` (the port runs the plain stem, whose math the fast stem
shares) and ``--platform`` (``--device`` names the device). ``--model``
other than ``poolresnet`` raises through ``build_model`` (item 4); the SSD
trains through ``fdtpu_torch.train_model_ssd``.
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
from fdtpu_torch.models import DTYPES, build_model
from fdtpu_torch.train import Trainer
from fdtpu_torch.utils.config import DetectorConfig, TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default="data", help="WIDERFace root")
    p.add_argument("--model", default="poolresnet",
                   choices=["poolresnet", "resnet", "separable", "mobilenetv3"])
    p.add_argument("--input", type=int, default=480, help="square input size")
    p.add_argument("--patches", type=int, default=10, help="grid size config")
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=70)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--no-sam", action="store_true",
                   help="plain Adam (the reference's effective behavior)")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--box-capacity", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-train-images", type=int, default=0,
                   help="subset for quick runs (0 = all)")
    p.add_argument("--device-data", action="store_true",
                   help="stage the training set on the device once and draw each epoch "
                        "as a permutation there (implies no host rotation)")
    p.add_argument("--rotate-device", action="store_true",
                   help="run the Rotate augmentation on the device (the three-shear "
                        "kernels) instead of host-side PIL")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device_data and not (args.no_augment or args.rotate_device):
        # Staged frames can't carry host rotation (one frozen angle per image
        # forever), and silently dropping the reference's Rotate(p=0.2) would
        # change the training distribution, so imply the device kernels.
        print(
            "--device-data: enabling --rotate-device so the reference's "
            "Rotate(p=0.2) augmentation is kept (host rotation cannot run "
            "on staged frames); pass --rotate-device explicitly to silence "
            "or --no-augment to disable augmentation",
            flush=True,
        )
        args.rotate_device = True
    run_name = (
        f"{args.model}_{args.filters}_{args.patches}x{args.patches}_"
        f"{args.input}x{args.input}"
    )  # run-identity string like the reference's train_model.py:21-25
    model_cfg = DetectorConfig(
        filters=args.filters,
        input_shape=(args.input, args.input),
        num_patches=args.patches,
        num_residual_blocks=args.blocks,
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
        rotate_device=args.rotate_device,
        device_data=args.device_data,
    )

    download_dataset_files(args.data_dir)
    train_targets = load_targets(args.data_dir, "train", max_faces=3)
    val_targets = load_targets(args.data_dir, "val", max_faces=3)
    if args.max_train_images:
        train_targets = train_targets[: args.max_train_images]
        val_targets = val_targets[: max(args.max_train_images // 4, 1)]

    shape = model_cfg.input_shape
    train_src = WIDERFaceDataSource(
        train_targets, shape, args.box_capacity,
        # host rotation is off under --rotate-device (device kernels do it)
        # and --device-data (frames are staged once; pass --rotate-device)
        rotate_prob=0.0 if (args.no_augment or args.rotate_device or args.device_data) else 0.2,
        seed=args.seed,
    )
    val_src = WIDERFaceDataSource(val_targets, shape, args.box_capacity)
    train_loader = BatchLoader(train_src, args.batch_size, shuffle=True, seed=args.seed,
                               drop_last=True)
    val_loader = BatchLoader(val_src, args.batch_size)

    module = build_model(args.model, model_cfg, args.device,
                         torch.Generator().manual_seed(args.seed),
                         compute_dtype=DTYPES[model_cfg.dtype])
    trainer = Trainer(
        module, train_cfg, train_loader, val_loader,
        augment=not args.no_augment, run_name=run_name, device=args.device,
    )
    if args.resume:
        trainer.maybe_resume()
    out = trainer.fit()
    print(f"final: {out}")
    ckpt = trainer.save()
    print(f"saved: {ckpt}")
    return ckpt


if __name__ == "__main__":
    main()
