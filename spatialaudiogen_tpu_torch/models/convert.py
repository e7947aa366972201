"""Weight bridge between the JAX package's variable tree and this package's
state_dict, and the port's checkpoint format.

Flat keys are the JAX package's own '/'-joined variable paths
(`params/audio_encoder/conv1/conv/kernel`,
`batch_stats/video_encoder/conv1/bn/mean`, ...). This package names its
modules as the Flax modules are named, so a state_dict key is the path
without its collection, '.'-joined, with `kernel` called `weight`. Layouts:

  conv kernel    HWIO -> OIHW
  dense kernel   (in, out) -> (out, in)
  deconv kernel  HWIO -> (in, out, kh, kw), spatially flipped: the JAX deconv
                 is an unflipped lhs-dilated conv, conv_transpose2d is its
                 adjoint form
  BN             scale/bias (params) and mean/var (batch_stats) as they are

A model dir for this package holds `train-params.json` and `params.npz`
with the flat JAX layout: framework-neutral, readable without JAX
(tools/export_torch_weights.py writes it from a JAX checkpoint).
"""

from __future__ import annotations

import os

import numpy as np
import torch

PARAMS_FILE = "params.npz"
_BATCH_STATS = ("mean", "var")


def from_flax(flat: dict) -> dict:
    """Flat JAX variables {path: array} -> state_dict {key: tensor}."""
    state = {}
    for key, val in flat.items():
        col, *path, leaf = key.split("/")
        if col not in ("params", "batch_stats"):
            raise ValueError(f"{key}: not a params/ or batch_stats/ variable")
        val = np.asarray(val)
        if leaf == "kernel":
            leaf = "weight"
            if val.ndim == 2:
                val = val.T
            elif path[-1] == "deconv":
                val = val.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                val = val.transpose(3, 2, 0, 1)
        state[".".join(path + [leaf])] = torch.from_numpy(np.array(val, order="C"))  # a copy
    return state


def to_flax(state: dict) -> dict:
    """state_dict {key: tensor} -> flat JAX variables {path: array}."""
    flat = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        val = val.detach().cpu().numpy()
        col = "batch_stats" if leaf in _BATCH_STATS else "params"
        if leaf == "weight":
            leaf = "kernel"
            if val.ndim == 2:
                val = val.T
            elif path[-1] == "deconv":
                val = val[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                val = val.transpose(2, 3, 1, 0)
        flat["/".join([col] + path + [leaf])] = np.ascontiguousarray(val)
    return flat


def save_params(model_dir: str, state: dict) -> str:
    """Write `state` as params.npz (flat JAX layout) into model_dir."""
    os.makedirs(model_dir, exist_ok=True)
    fn = os.path.join(model_dir, PARAMS_FILE)
    np.savez(fn, **to_flax(state))
    return fn


def load_params(model_dir: str) -> dict:
    """params.npz of model_dir -> state_dict."""
    fn = os.path.join(model_dir, PARAMS_FILE)
    if not os.path.exists(fn):
        raise FileNotFoundError(f"no {PARAMS_FILE} in {model_dir}; export a JAX "
                                f"checkpoint with tools/export_torch_weights.py")
    with np.load(fn) as npz:
        return from_flax({k: npz[k] for k in npz.files})
