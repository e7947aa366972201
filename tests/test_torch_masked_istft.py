"""K1, the fused masked comb-ISTFT: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its XLA reference, and the
wrapper's routing. The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances are those of tests/test_pallas.py: atol 2e-4 / rtol 1e-4 for
float32 masks (float32 reduction order), 2e-2 for bfloat16 masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ops.dft import stft_real as jax_stft_real
from spatialaudiogen_tpu.ops.pallas_kernels import masked_istft_pallas, masked_istft_reference
from spatialaudiogen_tpu_torch.ops import masked_istft as k1


def _inputs(b=2, n_in=1, tracks=3, wind=256, seed=0):
    """Spectra of a random signal and a sigmoid mask, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n_in, 9 * wind).astype(np.float32)
    re, im = (np.asarray(a) for a in jax_stft_real(x, wind, 4))
    t = re.shape[2]
    mask = 1 / (1 + np.exp(-rng.randn(b, n_in, tracks, t, wind).astype(np.float32)))
    return re, im, mask.astype(np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("b, n_in, tracks, wind, drop", [
    (2, 1, 3, 256, 0),     # tracks not a multiple of 8
    (1, 2, 10, 128, 0),    # two input channels, one full 8-track tile + 2
    (2, 1, 5, 128, 2),     # T not a multiple of 4: trailing frames dropped
])
def test_plain_matches_pallas_and_reference(b, n_in, tracks, wind, drop):
    re, im, mask = _inputs(b, n_in, tracks, wind)
    if drop:
        re, im, mask = re[:, :, :-drop], im[:, :, :-drop], mask[:, :, :, :-drop]
    pallas = np.asarray(masked_istft_pallas(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(mask), 4, True))
    ref = np.asarray(masked_istft_reference(re, im, mask, 4))
    got = k1.masked_istft_plain(*_torch(re, im, mask), 4).numpy()
    assert got.shape == pallas.shape == ref.shape
    np.testing.assert_allclose(got, pallas, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_plain_bf16_mask_matches_pallas():
    re, im, mask = _inputs(b=1, tracks=2, wind=128, seed=2)
    mask16 = jnp.asarray(mask).astype(jnp.bfloat16)
    pallas = np.asarray(masked_istft_pallas(jnp.asarray(re), jnp.asarray(im), mask16, 4, True))
    tmask = torch.from_numpy(np.array(mask16.astype(jnp.float32))).to(torch.bfloat16)
    got = k1.masked_istft_plain(*_torch(re, im), tmask, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-2, rtol=2e-2)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    re, im, mask = _torch(*_inputs(tracks=4, wind=128, seed=3))
    count = k1.launch_count
    got = k1.masked_istft(re, im, mask, 4, "default")
    assert torch.equal(got, k1.masked_istft_plain(re, im, mask, 4))
    assert k1.launch_count == count, "the CPU route must not count as a kernel launch"


def test_wrapper_rejects_what_no_route_takes():
    re, im, mask = _torch(*_inputs(b=1, tracks=2, wind=128))
    with pytest.raises(ValueError, match="precision"):
        k1.masked_istft(re, im, mask, 4, "high")
    with pytest.raises(ValueError, match="different devices"):
        k1.masked_istft(re, im, mask.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k1.masked_istft(re.to("meta"), im.to("meta"), mask.to("meta"))


def test_library_path_follows_the_source():
    path = k1.library_path()
    assert path.parent == k1.BUILD_DIR and path.suffix == ".so"
    assert path == k1.library_path()
