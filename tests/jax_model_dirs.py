"""JAX model dirs for the port's parity tests (tests/test_torch_sharded_*.py,
tests/test_torch_order2.py): a reduced configuration initialised by the
JAX package, checkpointed and exported to params.npz with
tools/export_torch_weights.py.

`jitted_init()` patches the JAX package's create_train_state with one
jitted program per model configuration while a module's fixture runs:
eager, on XLA:CPU, it compiles every op of the forward on first use, and
the JAX engines, the Evaluator and the export call it only for a restore
target's structure.
"""

from __future__ import annotations

import contextlib
import os
import sys

import jax
import numpy as np
import pytest

import spatialaudiogen_tpu.deploy.deploy as jax_deploy
import spatialaudiogen_tpu.eval.evaluator as jax_evaluator
import spatialaudiogen_tpu.train.state as jax_state
from spatialaudiogen_tpu.config import TrainConfig
from spatialaudiogen_tpu.models import SptAudioGen
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import export  # noqa: E402

FRAME_HW = (64, 128)


@contextlib.contextmanager
def jitted_init():
    original = jax_state.create_train_state
    programs = {}

    def create(model, tx, rng, batch):
        key = repr(model.cfg)
        if key not in programs:
            programs[key] = jax.jit(lambda r: original(model, tx, r, batch))
        return programs[key](rng)

    patch = pytest.MonkeyPatch()
    for module in (jax_state, jax_deploy, jax_evaluator):
        patch.setattr(module, "create_train_state", create)
    try:
        yield
    finally:
        patch.undo()


def jax_model_dir(path: str, db: str, encoders=("audio", "video"), separation="unet_mask",
                  ambi_order: int = 1, seed: int = 3) -> str:
    """A model dir at `path` (8 tracks, 64x128 frames) with the JAX
    package's initialisation from `seed`, exported for the port."""
    cfg = TrainConfig(db_dir=db, model_dir=path, encoders=tuple(encoders),
                      separation=separation, num_sep_tracks=8, frame_hw=FRAME_HW,
                      ambi_order=ambi_order, n_data=1)
    cfg.save()
    g = cfg.model_config().geometry
    n_ch = g.num_ambi_channels
    example = {"ambix": np.zeros((1, g.snd_size, n_ch), np.float32),
               "audio_mask": np.ones((1, n_ch), np.float32)}
    if "video" in encoders:
        example["video"] = np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)
    state = jax_state.create_train_state(SptAudioGen(cfg.model_config()), make_optimizer(),
                                         jax.random.PRNGKey(seed), example)
    save_checkpoint(path, state, 1)
    export(path)
    return path
