"""Export a JAX model dir's checkpoint for the PyTorch port.

    python tools/export_torch_weights.py MODEL_DIR

Restores the latest orbax checkpoint of MODEL_DIR the way the JAX deploy
engine does (spatialaudiogen_tpu/deploy/deploy.py, through
train/checkpoint.restore_checkpoint) and writes its variables as
MODEL_DIR/params.npz beside train-params.json, keyed by the JAX variable
paths ('params/audio_encoder/conv1/conv/kernel', ...). That file plus
train-params.json is all spatialaudiogen_tpu_torch needs: it reads no
orbax and imports no JAX.
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


def export(model_dir: str) -> str:
    """Write model_dir/params.npz from model_dir's latest checkpoint."""
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
    state = create_train_state(SptAudioGen(mcfg), make_optimizer(),
                               jax.random.PRNGKey(0), example)
    state, step = restore_checkpoint(model_dir, state)
    assert step is not None, f"no checkpoint in {model_dir}"
    out = os.path.join(model_dir, "params.npz")
    np.savez(out, **flat_variables(state.params, state.batch_stats))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)
    print(f"wrote {export(args.model_dir)}")


if __name__ == "__main__":
    main()
