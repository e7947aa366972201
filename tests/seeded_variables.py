"""Flax variables drawn from a numpy seed, for the port's parity tests.

`seeded_variables(model, *args, seed=..., **kw)` traces the flax module's
init with jax.eval_shape (no XLA compile of the init program, which on
XLA:CPU costs seconds per model) and fills every leaf from
numpy.random.RandomState(seed): kernels and embeddings at a scale of
1/sqrt(fan_in), biases and BN offsets near 0, BN scales near 1, running
means near 0 and running variances in [0.5, 1.5). -> nested numpy dict,
the structure `model.init` returns.
"""

from __future__ import annotations

import jax
import numpy as np


def _draw(name: str, shape: tuple, rng: np.random.RandomState) -> np.ndarray:
    if name in ("kernel", "embedding"):
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        value = rng.randn(*shape) / np.sqrt(fan_in)
    elif name == "scale":
        value = 1.0 + 0.1 * rng.randn(*shape)
    elif name == "var":
        value = 0.5 + rng.rand(*shape)
    else:                       # bias, mean
        value = 0.05 * rng.randn(*shape)
    return value.astype(np.float32)


def seeded_variables(model, *args, seed: int = 0, **kw) -> dict:
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.RandomState(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(
        tree, [_draw(path[-1].key, tuple(leaf.shape), rng) for path, leaf in leaves])
