"""The port's matmul DFT (spatialaudiogen_tpu_torch.ops.dft) against the JAX
package's (spatialaudiogen_tpu.ops.dft) on the same numpy inputs."""

import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ops import dft as jdft
from spatialaudiogen_tpu_torch.ops import dft as tdft


def _signal(wind: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(2, 1, 9 * wind + 37).astype(np.float32)


def test_bases_are_the_jax_bits():
    c, s = tdft.basis(256, "cpu")
    jc, js = jdft._basis(256)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("wind", [256, 1024])
@pytest.mark.parametrize("t0, n_frames", [(0, 8), (5, 19), (30, 9)])
def test_frame_signal_range_is_exact(wind, t0, n_frames):
    """Pure data movement (strided view + zero padding past the end):
    bit-identical frames, including frames that reach into the padding."""
    x = _signal(wind, seed=t0)
    want = np.asarray(jdft.frame_signal_range(x, wind, 4, t0, n_frames))
    got = tdft.frame_signal_range(torch.from_numpy(x), wind, 4, t0, n_frames).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wind", [256, 1024])
def test_stft_real_frame_range_matches_jax(wind):
    """atol 5e-3, the tolerance tests/test_ops_dft.py holds stft_real to."""
    x = _signal(wind, seed=1)
    t0, n = 3, 26
    jre, jim = jdft.stft_real(x, wind, 4, frame_start=t0, n_frames=n)
    re, im = tdft.stft_real(torch.from_numpy(x), wind, 4, t0, n)
    assert re.shape == jre.shape == (2, 1, n, wind)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=5e-3)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=5e-3)


@pytest.mark.parametrize("wind", [256, 1024])
@pytest.mark.parametrize("n_frames", [16, 18])
def test_istft_real_matches_jax(wind, n_frames):
    """atol 2e-4, as tests/test_ops_dft.py; 18 frames drops the trailing
    two like the JAX overlap-add."""
    rng = np.random.RandomState(2)
    re = rng.randn(2, n_frames, wind).astype(np.float32)
    im = rng.randn(2, n_frames, wind).astype(np.float32)
    want = np.asarray(jdft.istft_real(re, im, 4))
    got = tdft.istft_real(torch.from_numpy(re), torch.from_numpy(im), 4).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_roundtrip_halves_the_signal():
    """stft_real -> istft_real is 0.5x the signal on the interior (the comb
    overlap-add of a Hann analysis), as the JAX package's roundtrip test."""
    wind = 256
    x = np.random.RandomState(4).randn(1, 10 * wind).astype(np.float32)
    n = (x.shape[-1] - wind) // (wind // 4) + 1
    re, im = tdft.stft_real(torch.from_numpy(x), wind, 4, 0, n)
    y = tdft.istft_real(re, im, 4).numpy()
    offset, lo, hi = 3 * wind // 4, wind, y.shape[-1] - wind
    np.testing.assert_allclose(y[:, lo:hi], 0.5 * x[:, offset + lo: offset + hi],
                               atol=2e-3, rtol=1e-2)
