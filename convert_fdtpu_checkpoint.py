"""Convert a checkpoint that fdtpu wrote (Orbax) into a checkpoint of the
PyTorch port (``fdtpu_torch``).

It reads two forms:

* a Trainer checkpoint (``train_model.py``/``train_model_ssd.py``'s
  ``checkpoints/RUN/step_N``: the step, params, BatchNorm statistics and
  optax state). It is restored with fdtpu's ``restore_checkpoint`` against
  a template from ``create_train_state`` built from the model flags and the
  checkpoint's optimizer (Adam where its state holds ``mu``/``nu``, else
  SGD), mapped with ``fdtpu_torch.compat.train_state_from_fdtpu`` and
  written as ``OUT/step_%08d.pt`` by the port's ``save_checkpoint``: with
  ``checkpoint_dir``/run name at ``OUT``, the port's ``Trainer.maybe_resume``
  continues from it;
* a bare variables tree (``pruner.py --save``): read with fdtpu's
  ``restore_variables``, mapped with ``state_dict_from_fdtpu`` and written
  as ``OUT/step_00000000.pt`` holding ``{"step": 0, "module": ...}``, the
  form the port's ``pruner`` writes, for ``demo_model``,
  ``run_validation_epoch``, ``pruner`` and ``convert_*`` (a pruned tree
  converts with ``--filters`` at its kept width).

A tree that fits neither form, or not the model of the flags, raises and
names the mismatch. The model flags are ``train_model``'s (``--model
ssd`` takes its patch sizes from ``--input``, as ``train_model_ssd``). The
script imports jax, orbax and fdtpu, so it runs where they are installed,
on the CPU; the port itself imports none of them. Run as::

    python convert_fdtpu_checkpoint.py --checkpoint RUN_DIR --out DIR \\
        --model poolresnet --input 480 --patches 10 --filters 128 --blocks 10
"""

from __future__ import annotations

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import torch

from fdtpu.models import build_model as jax_build_model
from fdtpu.train.checkpoint import latest_checkpoint, restore_checkpoint, restore_variables
from fdtpu.train.state import create_train_state as jax_create_train_state
from fdtpu.utils.config import DetectorConfig as JaxDetectorConfig
from fdtpu.utils.config import TrainConfig as JaxTrainConfig
from fdtpu_torch.compat import state_dict_from_fdtpu, train_state_from_fdtpu
from fdtpu_torch.models import FAMILIES, build_model
from fdtpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
from fdtpu_torch.utils.config import DetectorConfig, TrainConfig

TRAINER_KEYS = {"step", "params", "batch_stats", "opt_state"}
VARIABLES_KEYS = {"params", "batch_stats"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="an Orbax step directory, or a run directory (its latest step)")
    p.add_argument("--out", required=True, help="directory for the port's step_%%08d.pt")
    p.add_argument("--model", default="poolresnet", choices=list(FAMILIES))
    p.add_argument("--input", type=int, default=480, help="square input size")
    p.add_argument("--patches", type=int, default=10, help="grid size config")
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=10)
    return p.parse_args(argv)


def step_directory(path: str | Path) -> Path:
    """``path`` itself, or the latest ``step_*`` inside it."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    return latest_checkpoint(path) or path


def checkpoint_tree(path: Path) -> dict:
    """The checkpoint's tree of array metadata (shapes and dtypes)."""
    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(path.absolute()).item_metadata
    tree = meta.tree if hasattr(meta, "tree") else meta
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a tree of named arrays")
    return tree


def check_fits(tree: dict, params, what: str) -> None:
    """Raise a ValueError naming the first param whose path or shape differs
    between the checkpoint's ``tree`` and the model's ``params``."""
    def leaves(t):
        return {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}

    got, want = leaves(tree), leaves(params)
    for key in sorted(set(got) | set(want)):
        if got.get(key) != want.get(key):
            raise ValueError(f"the {what} does not fit the model of the flags: params{key} is "
                             f"{got.get(key, 'missing')} there and {want.get(key, 'missing')} "
                             "in the model")


def adam_in(opt_state) -> bool:
    """Whether an optax state tree (of the checkpoint's metadata) holds
    Adam's moments."""
    if isinstance(opt_state, dict):
        return {"mu", "nu"} <= set(opt_state) or any(map(adam_in, opt_state.values()))
    if isinstance(opt_state, (list, tuple)):
        return any(map(adam_in, opt_state))
    return False


def convert(args) -> Path:
    """Write the port's checkpoint of ``args.checkpoint`` into ``args.out``
    and return its path."""
    path = step_directory(args.checkpoint)
    tree = checkpoint_tree(path)
    cfg = dict(filters=args.filters, input_shape=(args.input, args.input),
               num_patches=args.patches, num_residual_blocks=args.blocks)
    jm = jax_build_model(args.model, JaxDetectorConfig(**cfg))
    module = build_model(args.model, DetectorConfig(**cfg), "cpu",
                         torch.Generator().manual_seed(0))
    keys = set(tree)
    if TRAINER_KEYS - {"batch_stats"} <= keys <= TRAINER_KEYS:
        optimizer = "adam" if adam_in(tree["opt_state"]) else "sgd"
        jcfg = JaxTrainConfig(optimizer=optimizer)
        abstract = jax.eval_shape(
            lambda: jax_create_train_state(jm, jcfg, jax.random.PRNGKey(0))[0])
        check_fits(tree["params"], abstract.params, "Trainer checkpoint")
        device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        template = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=device), abstract)
        state = jax.tree.map(np.asarray, restore_checkpoint(path, template))
        ts = train_state_from_fdtpu(state, module, TrainConfig(optimizer=optimizer))
        out = save_checkpoint(args.out, ts)
        print(f"{path}: a Trainer state at step {ts.step} ({optimizer}) -> {out}")
        return out
    if "params" in keys and keys <= VARIABLES_KEYS:
        abstract = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, args.input, args.input, 3)), train=False))
        check_fits(tree["params"], abstract["params"], "variables tree")
        variables = jax.tree.map(np.asarray, restore_variables(path))
        module.load_state_dict(state_dict_from_fdtpu(variables["params"], module,
                                                     variables.get("batch_stats")))
        out = checkpoint_path(args.out, 0)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".tmp")
        torch.save({"step": 0, "module": module.state_dict()}, tmp)
        tmp.replace(out)
        print(f"{path}: a variables tree -> {out}")
        return out
    raise ValueError(f"{path}: neither a Trainer checkpoint ({sorted(TRAINER_KEYS)}) nor a "
                     f"variables tree ({sorted(VARIABLES_KEYS)}); it holds {sorted(keys)}")


def main(argv=None) -> Path:
    return convert(parse_args(argv))


if __name__ == "__main__":
    main()
