"""Checkpoints of the port (its counterpart of spatialaudiogen_tpu.train.
checkpoint, without orbax).

A model dir holds, after a save:
  params.npz      params and BN batch_stats in the JAX package's flat layout
                  (models.convert.save_params), so deploy.MonoToAmbix loads a
                  trained model as it is;
  train_state.pt  the step, the Adam state and the BN batch_stats, so that
                  training resumes where it stopped.
Each file is written to a temporary name and renamed into place; the step
is the one of the last save (max_to_keep=1, as the reference's Saver).
"""

from __future__ import annotations

import os

import torch

from spatialaudiogen_tpu_torch.models.convert import PARAMS_FILE, load_params, save_params
from spatialaudiogen_tpu_torch.train.state import TrainState

STATE_FILE = "train_state.pt"


def save_checkpoint(model_dir: str, state: TrainState) -> None:
    os.makedirs(model_dir, exist_ok=True)
    sd = state.model.state_dict()
    tmp_dir = os.path.join(model_dir, f".ckpt.{os.getpid()}")
    os.makedirs(tmp_dir, exist_ok=True)
    save_params(tmp_dir, sd)
    torch.save({"step": state.step,
                "optimizer": state.optimizer.state_dict(),
                "batch_stats": {k: v.detach().cpu() for k, v in sd.items()
                                if k.endswith((".mean", ".var"))}},
               os.path.join(tmp_dir, STATE_FILE))
    for name in (PARAMS_FILE, STATE_FILE):
        os.replace(os.path.join(tmp_dir, name), os.path.join(model_dir, name))
    os.rmdir(tmp_dir)


def latest_step(model_dir: str) -> int | None:
    fn = os.path.join(model_dir, STATE_FILE)
    if not os.path.exists(fn):
        return None
    return int(torch.load(fn, map_location="cpu", weights_only=True)["step"])


def restore_checkpoint(model_dir: str, state: TrainState) -> int | None:
    """Load the last save into `state` in place; returns its step, or None
    (state untouched) when model_dir holds no checkpoint."""
    fn = os.path.join(model_dir, STATE_FILE)
    if not os.path.exists(fn):
        return None
    saved = torch.load(fn, map_location="cpu", weights_only=True)
    sd = load_params(model_dir)
    sd.update(saved["batch_stats"])
    state.model.load_state_dict(sd, strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state.step
