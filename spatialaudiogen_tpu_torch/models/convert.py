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

The reference's TF1 variable names (weights/biases/gamma/beta/moving_*,
the pretrained resnet18.npy's keys) map onto the nested JAX variables
through the numpy half of spatialaudiogen_tpu.models.convert, copied below
(normalize_tf_name, flax_path_index, to_tf_var_dict, restore_tf_var_dict;
`nest` and `flatten` move between the flat and the nested form). Matching
is on normalised paths: the wrapper levels ('conv', 'deconv', 'dense')
dropped and the leaves canonicalised; TF conv2d_transpose kernels are
(H, W, out, in) where the JAX ones are (H, W, in, out).
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


def nest(flat: dict) -> dict:
    """Flat {'params/a/b': x} -> nested {'params': {'a': {'b': x}}}."""
    tree: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten(tree: dict) -> dict:
    """Nested variables -> flat {'params/a/b': x}."""
    return {"/".join(path): val for path, val in _flatten(tree).items()}


_LEAF_MAP = {
    "weights": "kernel",
    "biases": "bias",
    "gamma": "scale",
    "beta": "bias",
    "moving_mean": "mean",
    "moving_variance": "var",
}
_WRAPPER_LEVELS = {"conv", "deconv", "dense"}


def normalize_tf_name(name: str) -> str:
    parts = name.split("/")
    parts[-1] = _LEAF_MAP.get(parts[-1], parts[-1])
    parts = [p for i, p in enumerate(parts) if not (p in _WRAPPER_LEVELS and i < len(parts) - 1)]
    return "/".join(parts)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _normalize_flax_path(path: tuple) -> str:
    parts = [p for i, p in enumerate(path) if not (p in _WRAPPER_LEVELS and i < len(path) - 1)]
    return "/".join(parts)


_INV_LEAF_MAP = {"kernel": "weights", "bias": "biases", "scale": "gamma",
                 "mean": "moving_mean", "var": "moving_variance"}


def to_tf_var_dict(variables: dict, transpose_deconv: bool = True) -> dict:
    """Inverse of restore_tf_var_dict: Flax variables -> {tf_var_name: array}.

    Emits the reference's TF1 variable names (weights/biases/gamma/beta/
    moving_*; resnet.py:238-249 naming) so a framework checkpoint can be
    written back into a reference-loadable bundle. Deconv kernels are
    transposed to TF's (H, W, out, in) layout.
    """
    out = {}
    index = flax_path_index(variables)
    for norm_key, (coll, path, _) in index.items():
        node = variables[coll]
        for p in path:
            node = node[p]
        value = np.asarray(node)
        parts = norm_key.split("/")
        leaf = path[-1]
        if leaf == "bias" and len(parts) >= 2 and parts[-2] == "bn":
            parts[-1] = "beta"
        else:
            parts[-1] = _INV_LEAF_MAP[leaf]
        name = "/".join(parts)
        if transpose_deconv and "deconv" in path and leaf == "kernel":
            value = value.transpose(0, 1, 3, 2)
        assert name not in out, f"tf name collision: {name}"
        out[name] = value
    return out


def flax_path_index(variables: dict) -> dict:
    """normalized path string -> (collection, tuple-path) for params+batch_stats."""
    index = {}
    for coll in ("params", "batch_stats"):
        if coll not in variables:
            continue
        for path, leaf in _flatten(variables[coll]).items():
            key = _normalize_flax_path(path)
            assert key not in index, f"normalized path collision: {key}"
            index[key] = (coll, path, leaf.shape if hasattr(leaf, "shape") else None)
    return index


def restore_tf_var_dict(tf_vars: dict, variables: dict, conv1_in_channels: int | None = None,
                        transpose_deconv: bool = True, strict: bool = False):
    """Return new Flax `variables` with values from a TF var-name dict.

    tf_vars: {tf_var_path: np.ndarray}. Unmatched TF entries are returned as
    the second element (for inspection); unmatched Flax params keep their
    current values (or raise if strict).
    """
    index = flax_path_index(variables)
    flat_updates: dict = {}
    unmatched = {}
    for name, value in tf_vars.items():
        key = normalize_tf_name(name)
        if key not in index:
            unmatched[name] = np.shape(value)
            continue
        coll, path, shape = index[key]
        value = np.asarray(value)
        if conv1_in_channels is not None and path[-1] == "kernel" and value.ndim == 4 \
                and any(p.startswith("conv1") for p in path) and value.shape[2] > conv1_in_channels:
            value = value[:, :, :conv1_in_channels, :]
        if transpose_deconv and "deconv" in path and path[-1] == "kernel":
            # TF conv2d_transpose kernel (H, W, out, in) -> Flax (H, W, in, out)
            value = value.transpose(0, 1, 3, 2)
        if shape is not None and tuple(value.shape) != tuple(shape):
            value = value.reshape(shape)
        flat_updates[(coll,) + path] = value

    if strict:
        matched = {("params",) + p if c == "params" else ("batch_stats",) + p
                   for c, p, _ in index.values()}

    def rebuild(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            p = prefix + (k,)
            if isinstance(v, dict):
                out[k] = rebuild(v, p)
            elif p in flat_updates:
                out[k] = np.asarray(flat_updates[p], dtype=np.asarray(v).dtype)
            else:
                out[k] = v
        return out

    new_vars = {coll: rebuild(variables[coll], (coll,)) for coll in variables}
    return new_vars, unmatched
