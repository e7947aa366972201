"""K3, the fused masked comb-ISTFT over an NHWC mask: the port's plain
version and wrapper against the JAX package's masked_istft_nhwc_pallas
(interpret mode, as tests/test_pallas.py runs it), forward and gradients.
The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances are those of tests/test_pallas.py: atol 2e-4 / rtol 1e-4 for
the forward and 5e-3 / 1e-3 for the gradients with float32 masks (float32
reduction order), 2e-2 for the forward with a bfloat16 mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.ops.dft import stft_real as jax_stft_real
from spatialaudiogen_tpu.ops.pallas_kernels import masked_istft_nhwc_pallas
from spatialaudiogen_tpu_torch.ops import masked_istft as k


def _inputs(b=2, tracks=3, wind=256, seed=0):
    """Mono spectra (B, T, F) of a random signal and a sigmoid mask
    (B, T, F, TR), as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 1, 9 * wind).astype(np.float32)
    re, im = (np.asarray(a)[:, 0] for a in jax_stft_real(x, wind, 4))
    t = re.shape[1]
    mask = 1 / (1 + np.exp(-rng.randn(b, t, wind, tracks).astype(np.float32)))
    return re, im, mask.astype(np.float32)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _pallas(re, im, mask):
    return np.asarray(masked_istft_nhwc_pallas(jnp.asarray(re), jnp.asarray(im),
                                               jnp.asarray(mask), 4, True))


@pytest.mark.parametrize("b, tracks, wind", [
    (2, 12, 256),    # tests/test_pallas.py's case: tracks not a multiple of 8
    (1, 5, 128),     # tracks not a multiple of 4
])
def test_plain_matches_pallas(b, tracks, wind):
    re, im, mask = _inputs(b, tracks, wind)
    want = _pallas(re, im, mask)
    got = k.masked_istft_nhwc_plain(*_torch(re, im, mask), 4).numpy()
    assert got.shape == want.shape == (b, tracks, (re.shape[1] // 4) * wind - 3 * wind // 4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_wrapper_reads_a_channels_last_crop_in_place():
    """The model's mask: a frame crop of a channels_last (B, TR, H, F)
    tensor, viewed (B, T, F, TR). The wrapper takes the view as it is and
    gives what the JAX kernel gives on the same values, and what K1's
    plain version gives on the mask made track-major."""
    re, im, mask = _inputs(b=2, tracks=8, wind=128, seed=4)
    b, t, f, tracks = mask.shape
    full = torch.rand((b, tracks, t + 5, f)).contiguous(memory_format=torch.channels_last)
    view = full[:, :, 3:3 + t].permute(0, 2, 3, 1)
    view.copy_(torch.from_numpy(mask))
    assert view.stride() == ((t + 5) * f * tracks, f * tracks, tracks, 1)
    rt, it = _torch(re, im)
    got = k.masked_istft_nhwc(rt, it, view, 4, "default")
    np.testing.assert_allclose(got.numpy(), _pallas(re, im, mask), atol=2e-4, rtol=1e-4)
    tm = view.permute(0, 3, 1, 2)[:, None].contiguous()
    assert torch.equal(got, k.masked_istft_plain(rt[:, None], it[:, None], tm)[:, 0])


def test_gradients_match_pallas():
    """Gradients in re, im and the mask against jax.grad of the Pallas
    kernel (whose VJP transposes the mask and runs K2's Pallas kernel)."""
    re, im, mask = _inputs(b=1, tracks=2, wind=128, seed=1)

    def loss_k(r, i, m):
        return jnp.sum(masked_istft_nhwc_pallas(r, i, m, 4, True) ** 2)

    want = jax.grad(loss_k, argnums=(0, 1, 2))(jnp.asarray(re), jnp.asarray(im),
                                               jnp.asarray(mask))
    args = [x.requires_grad_() for x in _torch(re, im, mask)]
    (k.masked_istft_nhwc(*args) ** 2).sum().backward()
    for name, a, w in zip(("re", "im", "mask"), args, want):
        assert a.grad.shape == w.shape, name
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=5e-3, rtol=1e-3,
                                   err_msg=name)


def test_bf16_mask_forward_and_gradient_dtype():
    re, im, mask = _inputs(b=1, tracks=2, wind=128, seed=2)
    mask16 = jnp.asarray(mask).astype(jnp.bfloat16)
    want = np.asarray(masked_istft_nhwc_pallas(jnp.asarray(re), jnp.asarray(im),
                                               mask16, 4, True))
    tmask = torch.from_numpy(np.array(mask16.astype(jnp.float32))).to(torch.bfloat16)
    tmask.requires_grad_()
    got = k.masked_istft_nhwc(*_torch(re, im), tmask)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-2, rtol=2e-2)
    (got ** 2).sum().backward()
    assert tmask.grad.dtype == torch.bfloat16, "d_mask must keep the mask's dtype"


def test_trailing_frames_are_dropped_with_zero_gradient():
    """T not a multiple of 4: the output drops the trailing frames, as
    tests/test_pallas.py:120-139 holds the JAX kernel to, and they get zero
    gradient."""
    re, im, mask = _inputs(b=2, tracks=2, wind=128)
    re, im, mask = re[:, :-2], im[:, :-2], mask[:, :-2]
    assert re.shape[1] % 4 == 2
    want = _pallas(re, im, mask)
    tmask = torch.from_numpy(mask).requires_grad_()
    got = k.masked_istft_nhwc(*_torch(re, im), tmask)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4, rtol=1e-4)
    (got ** 2).sum().backward()
    g_want = jax.grad(lambda m: jnp.sum(masked_istft_nhwc_pallas(
        jnp.asarray(re), jnp.asarray(im), m, 4, True) ** 2))(jnp.asarray(mask))
    np.testing.assert_allclose(tmask.grad.numpy(), np.asarray(g_want), atol=5e-3, rtol=1e-3)
    assert float(tmask.grad[:, -2:].abs().max()) == 0.0


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    re, im, mask = _torch(*_inputs(tracks=4, wind=128, seed=3))
    count = k.nhwc_launch_count
    got = k.masked_istft_nhwc(re, im, mask, 4, "highest")
    assert torch.equal(got, k.masked_istft_nhwc_plain(re, im, mask, 4))
    assert k.nhwc_launch_count == count, "the CPU route must not count as a kernel launch"
    with pytest.raises(ValueError, match="precision"):
        k.masked_istft_nhwc(re, im, mask, 4, "high")
    with pytest.raises(ValueError, match="different devices"):
        k.masked_istft_nhwc(re, im, mask.to("meta"))
