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

Both hold full tensors whatever the mesh: a tensor-parallel run gathers
its shards before rank 0 writes, and a restore cuts them to the restoring
rank's rows, so a checkpoint from any mesh restores on any other, as the
JAX package promises (train/checkpoint.py:18-22).

A JAX run carries over through tools/export_torch_weights.py: params.npz,
and with --with_optimizer opt_state.npz, optax's Adam state (`count`, and
`mu/<path>`, `nu/<path>` under the JAX variable paths). A model dir with
both and no train_state.pt gets one built from them at its first restore.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spatialaudiogen_tpu_torch.models.convert import (
    PARAMS_FILE,
    from_flax,
    load_params,
    save_params,
)
from spatialaudiogen_tpu_torch.parallel.mesh import gather_full, slice_local
from spatialaudiogen_tpu_torch.train.state import TrainState

STATE_FILE = "train_state.pt"
OPT_STATE_FILE = "opt_state.npz"
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(state: TrainState, opt: dict, fn) -> dict:
    """A copy of the optimizer state dict `opt` with fn({name: moment})
    applied to each parameter's Adam moments."""
    names = [n for n, _ in state.model.named_parameters()]
    out = dict(opt, state={})
    for i, entry in opt["state"].items():
        entry = dict(entry)
        for key in _MOMENTS:
            if key in entry:
                entry[key] = fn({names[i]: entry[key]})[names[i]]
        out["state"][i] = entry
    return out


def save_checkpoint(model_dir: str, state: TrainState) -> None:
    """Write the full state (every rank of a mesh must call: the shards are
    gathered; rank 0 alone writes)."""
    mesh = state.mesh
    model = state.model
    sd = gather_full(model.state_dict(), model, mesh)
    opt = _map_moments(state, state.optimizer.state_dict(),
                       lambda t: gather_full(t, model, mesh))
    if mesh is not None and not mesh.is_primary:
        return
    os.makedirs(model_dir, exist_ok=True)
    tmp_dir = os.path.join(model_dir, f".ckpt.{os.getpid()}")
    os.makedirs(tmp_dir, exist_ok=True)
    save_params(tmp_dir, sd)
    torch.save({"step": state.step,
                "optimizer": opt,
                "batch_stats": {k: v.detach().cpu() for k, v in sd.items()
                                if k.endswith((".mean", ".var"))}},
               os.path.join(tmp_dir, STATE_FILE))
    for name in (PARAMS_FILE, STATE_FILE):
        os.replace(os.path.join(tmp_dir, name), os.path.join(model_dir, name))
    os.rmdir(tmp_dir)


def _has_jax_optimizer(model_dir: str) -> bool:
    return all(os.path.exists(os.path.join(model_dir, f))
               for f in (PARAMS_FILE, OPT_STATE_FILE))


def latest_step(model_dir: str) -> int | None:
    fn = os.path.join(model_dir, STATE_FILE)
    if os.path.exists(fn):
        return int(torch.load(fn, map_location="cpu", weights_only=True)["step"])
    if _has_jax_optimizer(model_dir):
        with np.load(os.path.join(model_dir, OPT_STATE_FILE)) as npz:
            return int(npz["count"])
    return None


def import_jax_optimizer(model_dir: str, state: TrainState) -> dict:
    """The train_state.pt contents for a model dir exported with
    --with_optimizer: Adam's `step` and `state.step` from optax's `count`,
    `exp_avg`/`exp_avg_sq` from `mu`/`nu` in the port's layouts
    (models.convert.from_flax: dense kernels transposed, conv kernels
    OIHW, deconv kernels flipped), the BN batch_stats from params.npz."""
    with np.load(os.path.join(model_dir, OPT_STATE_FILE)) as npz:
        count = int(npz["count"])
        moments = {key: from_flax({k[len(key) + 1:]: npz[k] for k in npz.files
                                   if k.startswith(key + "/")})
                   for key in ("mu", "nu")}
    names = [n for n, _ in state.model.named_parameters()]
    missing = [n for n in names if n not in moments["mu"] or n not in moments["nu"]]
    if missing:
        raise KeyError(f"{OPT_STATE_FILE} in {model_dir} has no Adam moments for "
                       f"{missing[:3]}")
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(float(count)),
                        "exp_avg": moments["mu"][n], "exp_avg_sq": moments["nu"][n]}
                    for i, n in enumerate(names)}
    return {"step": count, "optimizer": opt, "batch_stats": {}}


def restore_checkpoint(model_dir: str, state: TrainState) -> int | None:
    """Load the last save into `state` in place (each rank its own rows of
    the sharded tensors); returns its step, or None (state untouched) when
    model_dir holds no checkpoint. A dir with params.npz and opt_state.npz
    but no train_state.pt gets its train_state.pt built first (rank 0
    writes it)."""
    fn = os.path.join(model_dir, STATE_FILE)
    mesh = state.mesh
    if os.path.exists(fn):
        saved = torch.load(fn, map_location="cpu", weights_only=True)
    elif _has_jax_optimizer(model_dir):
        saved = import_jax_optimizer(model_dir, state)
        if mesh is None or mesh.is_primary:
            tmp = f"{fn}.{os.getpid()}"
            torch.save(saved, tmp)
            os.replace(tmp, fn)
    else:
        return None
    sd = load_params(model_dir)
    sd.update(saved["batch_stats"])
    state.model.load_state_dict(slice_local(sd, state.model, mesh), strict=True)
    state.optimizer.load_state_dict(_map_moments(
        state, saved["optimizer"], lambda t: slice_local(t, state.model, mesh)))
    state.step = int(saved["step"])
    return state.step
