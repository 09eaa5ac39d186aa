"""YOLO-grid detector training, the port's ``train_model.py``.

    python -m fdtpu_torch.train_model --data-dir DIR [--model mobilenetv3] [--device cuda]

The same flags and defaults as ``train_model.py`` for what is ported:
PoolResnet-128 @480px, 10x10 grid, 10 blocks, batch 8, lr 1e-4, 70 epochs,
SAM + Adam, MultiStepLR@40 x0.1, bf16 compute with float32 params; every
grid family of the zoo (``--model poolresnet | resnet | separable |
mobilenetv3``; MobileNetV3 trains with its BatchNorm state, and the grid
follows from ``--input``: 480 px gives 15); ``--pretrained-backbone PTH``
(MobileNetV3 only: the backbone of a reference TorchScript checkpoint under
a fresh head); plus ``--device`` (default ``cuda``; ``cpu`` only when
asked). Logs go to ``logs/out_<run>.log`` (+ ``.jsonl``, ``logs/tb/``),
checkpoints to ``checkpoints/<run>/step_*.pt``, both under the working
directory.

Data parallelism: ``--data-parallel N`` trains on N ranks, one a card: run
alone, the command starts them itself (gloo ranks on the CPU with
``--device cpu``); under ``torchrun --nproc-per-node N`` each rank joins
torchrun's group, and N must be its world size (-1 takes it).
``--multihost`` joins the group torchrun describes and implies
``--data-parallel -1``. ``--batch-size`` is the global batch; rank 0 writes
the logs and checkpoints.

On the card every train batch replays the step captured in a CUDA graph
(the metrics batch its own graph), and every val batch the captured eval
step, streamed or with ``--device-data``, in one process or in each NCCL
rank (its collectives in the graph); gloo ranks (``--device cpu``) run
the eager steps. ``--steps-per-dispatch K`` groups
the streamed batches by K as fdtpu does: one log line every
``log_every_steps // K`` groups, and with more than one rank fdtpu's
shard_map route for K > 1.

Left out: ``--no-fast-stem`` (the port runs the plain stem, whose math the
fast stem shares), ``--platform`` (``--device`` names the device) and
``--pretrained-backbone official`` (name the checkpoint's path). The SSD
trains through ``fdtpu_torch.train_model_ssd``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from fdtpu_torch.compat.torch_import import pretrained_backbone_variables
from fdtpu_torch.data import (
    BatchLoader,
    WIDERFaceDataSource,
    download_dataset_files,
    load_targets,
)
from fdtpu_torch.models import DTYPES, build_model
from fdtpu_torch.parallel.multihost import (
    entry_process_shard,
    join_entry_rank,
    shutdown,
    start_entry_ranks,
)
from fdtpu_torch.train import Trainer
from fdtpu_torch.train.checkpoint import latest_checkpoint
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
    p.add_argument("--pretrained-backbone", default=None, metavar="PTH",
                   help="mobilenetv3 only: initialize the backbone from a reference "
                        "TorchScript checkpoint (fresh head), the timm pretrained=True "
                        "analogue")
    p.add_argument("--box-capacity", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-train-images", type=int, default=0,
                   help="subset for quick runs (0 = all)")
    p.add_argument("--device-data", action="store_true",
                   help="stage the training set on the device once and draw each epoch "
                        "as a permutation there (implies no host rotation)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps a dispatch, fdtpu's groups of streamed batches: the "
                        "log cadence (each batch replays the captured step on a card)")
    p.add_argument("--rotate-device", action="store_true",
                   help="run the Rotate augmentation on the device (the three-shear "
                        "kernels) instead of host-side PIL")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="ranks (0 = one process, -1 = torchrun's world size or every visible "
                        "card); the batch size must divide")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun describes (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR/PORT); implies --data-parallel -1")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def run_name(args) -> str:
    """The run-identity string, like the reference's train_model.py:21-25."""
    return f"{args.model}_{args.filters}_{args.patches}x{args.patches}_{args.input}x{args.input}"


def build_trainer(args) -> Trainer:
    """The data, the model (with ``--pretrained-backbone``'s weights) and
    the Trainer that ``main`` fits, from parsed flags."""
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
    name = run_name(args)
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
        log_path=f"logs/out_{name}.log",
        checkpoint_dir="checkpoints",
        rotate_device=args.rotate_device,
        device_data=args.device_data,
        data_parallel=args.data_parallel,
        steps_per_dispatch=args.steps_per_dispatch,
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
    shard = entry_process_shard(args)
    train_loader = BatchLoader(train_src, args.batch_size, shuffle=True, seed=args.seed,
                               drop_last=True, process_shard=shard)
    val_loader = BatchLoader(val_src, args.batch_size, process_shard=shard)

    module = build_model(args.model, model_cfg, args.device,
                         torch.Generator().manual_seed(args.seed),
                         compute_dtype=DTYPES[model_cfg.dtype])
    if args.pretrained_backbone:
        if args.model != "mobilenetv3":
            raise SystemExit("--pretrained-backbone requires --model mobilenetv3")
        module.load_state_dict(pretrained_backbone_variables(args.pretrained_backbone, module))
        print(f"backbone initialized from {args.pretrained_backbone} (fresh head)")
    return Trainer(
        module, train_cfg, train_loader, val_loader,
        augment=not args.no_augment, run_name=name, device=args.device,
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
