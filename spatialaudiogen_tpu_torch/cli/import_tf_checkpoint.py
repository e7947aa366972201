"""Import a TF1 checkpoint (or an exported npz) into a model dir of the port;
the counterpart of the JAX package's tools/import_tf_checkpoint.py.

Builds the model from the model dir's train-params, maps the TF variable
names onto the JAX variable tree of its state_dict
(models.convert.restore_tf_var_dict over nest(to_flax(state_dict))), and
writes the model dir's params.npz and train_state.pt at --step with a
fresh Adam state (train/checkpoint.save_checkpoint), which deploy, eval,
serve and cli.train --resume load. The checkpoint is either

  * a released TF1 TensorBundle directly — a `model.ckpt-N` prefix, its
    `.index` file, or a directory holding one (reference README.md:70-78) —
    read TF-free by spatialaudiogen_tpu_torch.utils.tf_bundle, or
  * an npz (or a pickled-dict npy) keyed by TF variable names, as the JAX
    package's tools/export_tf_checkpoint.py writes (legacy two-step path).

Optimizer slots and bookkeeping in a bundle (`Adam*`, `beta1_power`,
`beta2_power`, `step`, `global_step`) are dropped. TF variables that match
no variable of the model are listed; they fail the import unless
--allow_unmatched is given. A file conversion: no model runs, and nothing
goes to the card.

    python -m spatialaudiogen_tpu_torch.cli.import_tf_checkpoint MODEL_DIR \\
        CKPT_OR_NPZ [--step 0] [--allow_unmatched]
"""

from __future__ import annotations

import argparse
import sys

BOOKKEEPING = ("step", "global_step")
OPTIMIZER_SLOTS = ("Adam", "beta1_power", "beta2_power")


def load_tf_variables(checkpoint: str) -> dict:
    """{TF variable name: array} of a bundle (optimizer slots and
    bookkeeping dropped) or of an npz/npy (as it is)."""
    if checkpoint.endswith((".npz", ".npy")):
        from spatialaudiogen_tpu_torch.models.resnet import load_npy_blob

        return dict(load_npy_blob(checkpoint))
    from spatialaudiogen_tpu_torch.utils.tf_bundle import load_tf_checkpoint

    blobs = load_tf_checkpoint(checkpoint)
    return {k: v for k, v in blobs.items()
            if not k.split("/")[-1].startswith(OPTIMIZER_SLOTS) and k not in BOOKKEEPING}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir", help="Target model dir (with train-params)")
    parser.add_argument("checkpoint",
                        help="TF1 model.ckpt-N prefix / .index / dir, or an "
                             "npz from export_tf_checkpoint.py")
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--allow_unmatched", action="store_true",
                        help="Do not fail when some TF variables stay unmatched.")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import (
        flatten,
        from_flax,
        nest,
        restore_tf_var_dict,
        to_flax,
    )
    from spatialaudiogen_tpu_torch.train.checkpoint import save_checkpoint
    from spatialaudiogen_tpu_torch.train.state import create_train_state

    cfg = TrainConfig.load(args.model_dir)
    cfg.model_dir = args.model_dir
    state = create_train_state(cfg, "cpu")

    blobs = load_tf_variables(args.checkpoint)
    variables = nest(to_flax(state.model.state_dict()))
    new_vars, unmatched = restore_tf_var_dict(blobs, variables)
    print(f"Matched {len(blobs) - len(unmatched)}/{len(blobs)} TF variables")
    if unmatched:
        for name, shape in sorted(unmatched.items()):
            print(f"  unmatched: {name} {shape}")
        if not args.allow_unmatched:
            sys.exit("Unmatched variables; re-run with --allow_unmatched to accept.")

    state.model.load_state_dict(from_flax(flatten(new_vars)), strict=True)
    state.step = args.step
    save_checkpoint(args.model_dir, state)
    print(f"Wrote checkpoint step {args.step} to {args.model_dir}")


if __name__ == "__main__":
    main()
