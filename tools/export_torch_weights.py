"""Export a JAX model dir's checkpoint for the PyTorch port.

    python tools/export_torch_weights.py MODEL_DIR [--with_optimizer]

Restores the latest orbax checkpoint of MODEL_DIR the way the JAX deploy
engine does (spatialaudiogen_tpu/deploy/deploy.py, through
train/checkpoint.restore_checkpoint) and writes its variables as
MODEL_DIR/params.npz beside train-params.json, keyed by the JAX variable
paths ('params/audio_encoder/conv1/conv/kernel', ...). That file plus
train-params.json is all spatialaudiogen_tpu_torch needs: it reads no
orbax and imports no JAX.

--with_optimizer also writes MODEL_DIR/opt_state.npz, optax's Adam state
(ScaleByAdamState): `count`, and `mu/<path>` and `nu/<path>` under the same
variable paths, so that the port's cli.train --resume carries on with the
moments and the step (spatialaudiogen_tpu_torch/train/checkpoint.py). The
state is found by its type, not its position in the optimizer chain
(train/lr.make_optimizer puts clip_by_global_norm in front when clip_norm
is set), and the checkpoint is restored with the run's own chain.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flat_variables(params, batch_stats) -> dict:
    import jax

    tree = {"params": params}
    if batch_stats:
        tree["batch_stats"] = batch_stats
    return {"/".join(k.key for k in path): np.asarray(jax.device_get(x))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def adam_state(opt_state):
    """The one optax ScaleByAdamState inside an optimizer state tree."""
    import jax
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1, f"{len(found)} Adam states in the optimizer state"
    return found[0]


def export(model_dir: str, with_optimizer: bool = False) -> str:
    """Write model_dir/params.npz (and with `with_optimizer`
    model_dir/opt_state.npz) from model_dir's latest checkpoint."""
    import jax

    from spatialaudiogen_tpu.config import TrainConfig
    from spatialaudiogen_tpu.models import SptAudioGen
    from spatialaudiogen_tpu.train.checkpoint import restore_checkpoint
    from spatialaudiogen_tpu.train.lr import make_optimizer
    from spatialaudiogen_tpu.train.state import create_train_state

    cfg = TrainConfig.load(model_dir)
    cfg.sample_dur = 0.1  # deploy geometry, as MonoToAmbix sets it
    mcfg = cfg.model_config()
    g = mcfg.geometry
    example = {"ambix": np.zeros((1, g.snd_size, g.num_ambi_channels), np.float32),
               "audio_mask": np.ones((1, g.num_ambi_channels), np.float32)}
    for key in ("video", "flow"):
        if key in cfg.encoders:
            example[key] = np.zeros((1, g.vid_dur) + tuple(cfg.frame_hw) + (3,),
                                    np.float32)
    tx = make_optimizer(cfg.lr, cfg.lr_decay, cfg.lr_iters, cfg.clip_norm)
    state = create_train_state(SptAudioGen(mcfg), tx, jax.random.PRNGKey(0), example)
    state, step = restore_checkpoint(model_dir, state)
    assert step is not None, f"no checkpoint in {model_dir}"
    out = os.path.join(model_dir, "params.npz")
    np.savez(out, **flat_variables(state.params, state.batch_stats))
    if with_optimizer:
        adam = adam_state(state.opt_state)
        moments = {f"{key}/{path}": value for key, tree in (("mu", adam.mu), ("nu", adam.nu))
                   for path, value in flat_variables(tree, None).items()}
        np.savez(os.path.join(model_dir, "opt_state.npz"),
                 count=np.asarray(jax.device_get(adam.count)), **moments)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("model_dir")
    parser.add_argument("--with_optimizer", action="store_true",
                        help="also write opt_state.npz, the Adam state")
    args = parser.parse_args(argv)
    print(f"wrote {export(args.model_dir, args.with_optimizer)}")


if __name__ == "__main__":
    main()
