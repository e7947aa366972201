"""Export a model dir of the port as a TF1 TensorBundle; the counterpart of
the JAX package's tools/export_to_tf_bundle.py, and the reverse of
cli/import_tf_checkpoint.py.

Loads the model dir's params.npz into the model its train-params build
(so a file that does not fit the configuration is refused), renames the
JAX variable tree to the reference's TF1 variable names
(models.convert.to_tf_var_dict: deconv kernels in TF's (H, W, out, in)),
adds `global_step` (int64, the step of the model dir's last save,
train/checkpoint.latest_step) and writes
`model.ckpt-<step>.{index,data-00000-of-00001}` plus a CheckpointState
file — loadable by the reference's `tf.train.Saver.restore` (reference
eval.py:117-118, resnet.py:238-249 naming). A model dir with no
checkpoint (no train_state.pt, and no opt_state.npz of a JAX export) is
refused. A file conversion: no model runs, and nothing goes to the card.

    python -m spatialaudiogen_tpu_torch.cli.export_to_tf_bundle MODEL_DIR OUT_DIR
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_dir", help="Model dir (train-params, params.npz, "
                                          "train_state.pt)")
    parser.add_argument("out_dir", help="Where to write the model.ckpt-* bundle")
    args = parser.parse_args(argv)

    from spatialaudiogen_tpu_torch.config import TrainConfig
    from spatialaudiogen_tpu_torch.models.convert import load_params, nest, to_flax, \
        to_tf_var_dict
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
    from spatialaudiogen_tpu_torch.train.checkpoint import latest_step
    from spatialaudiogen_tpu_torch.utils.tf_bundle import save_tf_checkpoint

    step = latest_step(args.model_dir)
    if step is None:
        sys.exit(f"no checkpoint in {args.model_dir}")
    cfg = TrainConfig.load(args.model_dir)
    model = SptAudioGen(cfg.model_config(), frame_hw=tuple(cfg.frame_hw))
    model.load_state_dict(load_params(args.model_dir), strict=True)

    tf_vars = to_tf_var_dict(nest(to_flax(model.state_dict())))
    tf_vars["global_step"] = np.array(step, np.int64)
    os.makedirs(args.out_dir, exist_ok=True)
    prefix = os.path.join(args.out_dir, f"model.ckpt-{step}")
    save_tf_checkpoint(prefix, tf_vars)
    print(f"Exported {len(tf_vars)} variables to {prefix}.*")
    return prefix


if __name__ == "__main__":
    main()
