"""K3, the fused masked comb-ISTFT over an NHWC mask: the port's plain
version and wrapper against the JAX package's masked_istft_nhwc_pallas
(interpret mode, as tests/test_pallas.py runs it), forward and gradients.
The CUDA kernel itself is tested in test_torch_cuda.py.

Tolerances are those of tests/test_pallas.py: atol 2e-4 / rtol 1e-4 for
the forward and 5e-3 / 1e-3 for the gradients with float32 masks (float32
reduction order), 2e-2 for the forward with a bfloat16 mask. The plain
version at precision="default" (the bf16 route's operands) is held as K1's
is in test_torch_masked_istft.py.
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
    (2, 8, 64),      # F = 64, the smallest F the CLIs' flags reach
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


# ---------------------------------------------------------------------------
# precision="default": the plain version of K3's bf16 route


def _jax_bf16_istft_nhwc(re, im, mask):
    """JAX's masked_istft_reference on the mask made track-major, with its
    two GEMM operands (the masked spectra and the bases) rounded to bf16:
    exact bf16 products summed in float32, then the JAX package's comb
    overlap-add. (B, T, F) spectra, (B, T, F, TR) mask -> (B, TR, out_len)."""
    from spatialaudiogen_tpu.ops.dft import _basis as jax_basis, _overlap_add as jax_ola

    f = re.shape[-1]
    c, s = (jnp.asarray(x).astype(jnp.bfloat16) for x in jax_basis(f))
    m = jnp.asarray(mask).transpose(0, 3, 1, 2)                 # (B, TR, T, F)
    rm = (jnp.asarray(re)[:, None] * m).astype(jnp.bfloat16)
    imm = (jnp.asarray(im)[:, None] * m).astype(jnp.bfloat16)
    x = (jnp.matmul(rm, c, preferred_element_type=jnp.float32)
         + jnp.matmul(imm, s, preferred_element_type=jnp.float32)) / float(f)
    return np.asarray(jax_ola(x, 4))


@pytest.mark.parametrize("b, tracks, seed", [(2, 3, 11), (1, 8, 14)])
def test_plain_default_matches_jax_on_bf16_operands(b, tracks, seed):
    """Both round the same float32 products and bases to bf16 and sum exact
    products in float32: only the summation order differs."""
    re, im, mask = _inputs(b=b, tracks=tracks, wind=256, seed=seed)
    want = _jax_bf16_istft_nhwc(re, im, mask)
    got = k.masked_istft_nhwc_plain(*_torch(re, im, mask), 4, "default").numpy()
    assert got.shape == want.shape == (b, tracks, (re.shape[1] // 4) * 256 - 3 * 64)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("tracks, seed", [(3, 12), (5, 15)])
def test_plain_default_is_bf16_away_from_f32(tracks, seed):
    """bf16 operands put the output about 2e-3 (relative L2) from the
    float32 function, the TPU's DEFAULT; below 1e-4 nothing was rounded,
    above 1e-2 something else went wrong."""
    args = _torch(*_inputs(b=2, tracks=tracks, wind=256, seed=seed))
    f32 = k.masked_istft_nhwc_plain(*args, 4, "highest")
    bf16 = k.masked_istft_nhwc_plain(*args, 4, "default")
    err = float((bf16 - f32).norm() / f32.norm())
    assert 1e-4 <= err <= 1e-2, err


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_cpu_route_ignores_pallas_precision(precision):
    """On the CPU, masked_istft_nhwc runs the float32 plain version whatever
    `precision` says, bit for bit, as the JAX model's non-Pallas branch
    does; so does the reduced NHWC model's forward."""
    from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen

    args = _torch(*_inputs(tracks=2, wind=256, seed=13))
    assert torch.equal(k.masked_istft_nhwc(*args, 4, precision),
                       k.masked_istft_nhwc_plain(*args, 4, "highest"))
    out = {}
    for prec in (precision, "highest"):
        cfg = SptAudioGenConfig(sep_num_tracks=2, pallas_nhwc=True, pallas_precision=prec)
        g = cfg.geometry
        gen = torch.Generator().manual_seed(1)
        audio = 0.1 * torch.randn((1, g.snd_size, 1), generator=gen)
        video = torch.rand((1, g.vid_dur, 32, 64, 3), generator=gen) - 0.5
        model = SptAudioGen(cfg, frame_hw=(32, 64)).init_weights(
            torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            out[prec] = model(audio, video)
    assert torch.equal(out[precision], out["highest"])


def _crop(b, tracks, t, f, dtype=torch.float32, start=2):
    """The model's mask: frames [start, start + t) of a channels_last
    (B, TR, t + 6, F) tensor, viewed (B, T, F, TR)."""
    full = torch.zeros((b, tracks, t + 6, f), dtype=dtype)
    full = full.contiguous(memory_format=torch.channels_last)
    return full[:, :, start:start + t].permute(0, 2, 3, 1)


@pytest.mark.parametrize("mask, t_use, vector", [
    (_crop(2, 32, 28, 256), 28, True),                     # the flagship's mask
    (_crop(2, 32, 28, 256, torch.bfloat16), 28, True),
    (_crop(3, 5, 30, 256), 28, False),                     # 5 tracks
    (_crop(2, 8, 20, 256), 20, False),                     # 6 tracks a block (T 20)
    (_crop(2, 8, 16, 256), 16, True),                      # 8 tracks a block (T 16)
    (_crop(2, 8, 28, 256)[..., ::2], 28, False),           # tracks strided
    (torch.zeros(2, 28, 256, 4), 28, True),                # contiguous NHWC
    (torch.zeros(2 * 28 * 256 * 4 + 1)[1:].view(2, 28, 256, 4), 28, False),   # unaligned base
])
def test_nhwc_vector_route(mask, t_use, vector):
    """K3 loads 4 tracks of a (t, f) at once only where every block's
    tracks come in aligned groups of 4; any other mask takes the scalar
    route of the same kernel (never a plain version)."""
    assert k.nhwc_vector_route(mask, t_use) is vector
