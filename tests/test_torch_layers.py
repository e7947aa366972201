"""The port's layers (spatialaudiogen_tpu_torch.models.layers) against the
Flax modules of spatialaudiogen_tpu.models.layers, at the same parameters
(through the weight bridge) and inputs. Port tensors are NCHW, the Flax
ones NHWC. Tolerances: float32 reduction-order noise."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import layers as jl
from spatialaudiogen_tpu_torch.models import layers as tl
from spatialaudiogen_tpu_torch.models.convert import from_flax


def flat(variables) -> dict:
    return {"/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _pair(jmod, tmod, x, **apply_kw):
    variables = jmod.init(jax.random.PRNGKey(0), x, **apply_kw)
    tmod.load_state_dict(from_flax(flat(variables)), strict=True)
    return variables


@pytest.mark.parametrize("hw, k, s", [((17, 30), 7, 2), ((9, 14), 3, 2), ((8, 8), 1, 2),
                                      ((10, 12), 3, 1)])
def test_conv2d_same_matches_flax(hw, k, s):
    """TF "SAME" pads more at the end at stride 2 (odd and even sizes)."""
    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    jmod = jl.Conv2D(6, (k, k), (s, s), padding="SAME", activation=fnn.relu)
    tmod = tl.Conv2D(5, 6, (k, k), (s, s), padding="SAME", activation=torch.relu)
    variables = _pair(jmod, tmod, x)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_conv2d_valid_strided_matches_flax():
    x = np.random.RandomState(1).randn(2, 31, 70, 3).astype(np.float32)
    jmod = jl.Conv2D(4, (7, 16), (4, 8), padding="VALID")
    tmod = tl.Conv2D(3, 4, (7, 16), (4, 8), padding="VALID")
    variables = _pair(jmod, tmod, x)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, x)), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("k, s", [((3, 5), (1, 1)), ((3, 7), (2, 4)), ((7, 16), (4, 8))])
def test_deconv2d_valid_matches_flax(k, s):
    """The JAX deconv is an unflipped lhs-dilated conv; the bridge flips the
    kernel for conv_transpose2d. out = in*stride + k - stride."""
    x = np.random.RandomState(2).randn(2, 4, 6, 5).astype(np.float32)
    jmod = jl.Deconv2D(3, k, s)
    tmod = tl.Deconv2D(5, 3, k, s)
    variables = _pair(jmod, tmod, x)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == want.shape == (2, 4 * s[0] + k[0] - s[0], 6 * s[1] + k[1] - s[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_batchnorm_batch_stats_matches_flax():
    """eps 1e-3, biased batch variance, running averages untouched."""
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 5, 6, 8) * 2 + 1).astype(np.float32)
    jmod = jl.BatchNorm(use_running_average=False)
    tmod = tl.BatchNorm(8)
    variables = jmod.init(jax.random.PRNGKey(0), x)
    params = {"params": {"scale": rng.rand(8).astype(np.float32) + 0.5,
                         "bias": rng.randn(8).astype(np.float32)},
              "batch_stats": {"mean": rng.randn(8).astype(np.float32),
                              "var": rng.rand(8).astype(np.float32) + 0.5}}
    variables = jax.tree_util.tree_map(lambda a, b: b, variables, params)
    tmod.load_state_dict(from_flax(flat(variables)), strict=True)
    want = np.asarray(jmod.apply(variables, x))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    with torch.no_grad():
        got = nhwc(tmod(nchw(x), batch_stats=True))
        running = nhwc(tmod(nchw(x), batch_stats=False))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k
    want_running = np.asarray(jl.BatchNorm(use_running_average=True).apply(variables, x))
    np.testing.assert_allclose(running, want_running, atol=1e-5, rtol=1e-5)


def test_dense_rank4_matches_flax():
    x = np.random.RandomState(4).randn(2, 3, 4, 7).astype(np.float32)
    jmod = jl.Dense(5, activation=fnn.relu)
    tmod = tl.Dense(7, 5, activation=torch.relu)
    variables = _pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, x)), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("hw", [(16, 32), (15, 29)])
def test_max_pool_same_matches_flax(hw):
    """3x3/2 "SAME" max-pool pads with -inf (negative inputs show it)."""
    x = (np.random.RandomState(5).randn(2, *hw, 3) - 3).astype(np.float32)
    want = np.asarray(fnn.max_pool(x, (3, 3), (2, 2), "SAME"))
    got = nhwc(tl.max_pool_same(nchw(x), 3, 2))
    np.testing.assert_array_equal(got, want)
