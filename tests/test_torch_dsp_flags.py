"""The port's FFT reference STFT (dsp.stft), the Hermitian DFT functions
(ops.dft) and the model's `hermitian_dft` and `remat` flags, against the
JAX package on the CPU.

Inputs are drawn from a seed with numpy and go through both packages;
weights come across through models.convert.from_flax. The model tests run
at tests/test_hermitian.py's reduced size (audio-only unet_mask, 4 tracks,
batch 1) and a reduced flagship for remat (audio + video, 4 tracks, 64x128
frames, batch 2).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import SptAudioGen, SptAudioGenConfig
from spatialaudiogen_tpu.ops import dft as jax_dft
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig as TorchConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen as TorchModel
from spatialaudiogen_tpu_torch.ops import dft as port_dft
from spatialaudiogen_tpu_torch.train.lr import make_optimizer
from spatialaudiogen_tpu_torch.train.state import TrainState
from spatialaudiogen_tpu_torch.train.steps import train_step
from seeded_variables import seeded_variables

torch.set_num_threads(1)
# the modules (each package's dsp/__init__ exports a function named stft)
jax_stft = importlib.import_module("spatialaudiogen_tpu.dsp.stft")
port_stft = importlib.import_module("spatialaudiogen_tpu_torch.dsp.stft")


def flat_variables(variables) -> dict:
    return {"/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("wind, overlap, n", [(256, 4, 5 * 256 + 37), (512, 4, 3 * 512),
                                              (128, 2, 1000), (64, 1, 700)])
def test_stft_istft_match_jax(wind, overlap, n):
    """frame_signal exactly; stft and istft within 1e-5 of jnp.fft
    (absolute, on unit-variance input)."""
    x = np.random.RandomState(wind + n).randn(2, n).astype(np.float32)
    frames = port_stft.frame_signal(torch.from_numpy(x), wind, overlap).numpy()
    np.testing.assert_array_equal(frames, np.asarray(jax_stft.frame_signal(x, wind, overlap)))
    want = np.asarray(jax_stft.stft(x, wind, overlap))
    got = port_stft.stft(torch.from_numpy(x), wind, overlap).numpy()
    assert got.shape == want.shape and np.iscomplexobj(got)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.sqrt(wind))
    back = port_stft.istft(torch.from_numpy(want.copy()), overlap).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_stft.istft(want, overlap)), atol=1e-5)


@pytest.mark.parametrize("window, overlap, n", [(1000, 4, 4800), (1200, 2, 4800),
                                                (256, 1, 1000)])
def test_stft_for_loss_matches_jax(window, overlap, n):
    sig = np.random.RandomState(window).randn(2, n, 3).astype(np.float32)
    want = np.asarray(jax_stft.stft_for_loss(sig, window, overlap))
    got = port_stft.stft_for_loss(torch.from_numpy(sig), window, overlap).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.sqrt(want.shape[-1]))


def test_hermitian_dft_functions_match_jax():
    """stft_real(half=True), mirror_hermitian_magnitude, stft_magnitude,
    fold_hermitian_mask, istft_from_masked and istft_from_masked_hermitian
    against JAX's (1e-5 absolute plus 1e-5 relative on the spectra, whose
    bins reach 15 here; 1e-6 absolute on the syntheses),
    and the half-spectrum synthesis against the full one (2e-4, as
    tests/test_hermitian.py holds JAX's)."""
    rng = np.random.RandomState(1)
    n = 256
    x = rng.randn(2, 6 * n).astype(np.float32)
    xt = torch.from_numpy(x)
    re_h, im_h = (t.numpy() for t in port_dft.stft_real(xt, n, 4, half=True))
    jre_h, jim_h = (np.asarray(t) for t in jax_dft.stft_real(x, n, 4, half=True))
    assert re_h.shape == (2, 20, n // 2 + 1)
    np.testing.assert_allclose(re_h, jre_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(im_h, jim_h, rtol=1e-5, atol=1e-5)
    mag_h = np.sqrt(re_h ** 2 + im_h ** 2)
    np.testing.assert_array_equal(
        port_dft.mirror_hermitian_magnitude(torch.from_numpy(mag_h)).numpy(),
        np.asarray(jax_dft.mirror_hermitian_magnitude(mag_h)))
    np.testing.assert_allclose(port_dft.stft_magnitude(xt, n, 4).numpy(),
                               np.asarray(jax_dft.stft_magnitude(x, n, 4)),
                               rtol=1e-5, atol=1e-5)
    mask = (1 / (1 + np.exp(-rng.randn(2, 3, 20, n)))).astype(np.float32)
    np.testing.assert_array_equal(
        port_dft.fold_hermitian_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jax_dft.fold_hermitian_mask(mask)))
    re, im = (np.array(t) for t in jax_dft.stft_real(x, n, 4))
    full = port_dft.istft_from_masked(torch.from_numpy(re[:, None]),
                                      torch.from_numpy(im[:, None]),
                                      torch.from_numpy(mask), 4).numpy()
    np.testing.assert_allclose(
        full, np.asarray(jax_dft.istft_from_masked(re[:, None], im[:, None], mask, 4)),
        atol=1e-6)
    half = port_dft.istft_from_masked_hermitian(
        torch.from_numpy(re[:, None, :, : n // 2 + 1]),
        torch.from_numpy(im[:, None, :, : n // 2 + 1]), torch.from_numpy(mask), 4,
        n_freqs=n).numpy()
    want = np.asarray(jax_dft.istft_from_masked_hermitian(
        re[:, None, :, : n // 2 + 1], im[:, None, :, : n // 2 + 1], mask, 4, n_freqs=n))
    np.testing.assert_allclose(half, want, atol=1e-6)
    np.testing.assert_allclose(half, full, atol=2e-4)


@pytest.fixture(scope="module")
def hermitian_pair():
    """JAX's audio-only unet_mask model with hermitian_dft on (seeded
    weights, and its output) at tests/test_hermitian.py's size."""
    cfg = SptAudioGenConfig(encoders=("audio",), separation="unet_mask",
                            sep_num_tracks=4, hermitian_dft=True)
    audio = np.random.RandomState(2).randn(1, cfg.geometry.snd_size, 1).astype(np.float32)
    model = SptAudioGen(cfg)
    variables = seeded_variables(model, audio, train=False, seed=0)
    out = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, audio))
    return flat_variables(variables), audio, out


@pytest.mark.parametrize("hermitian", [True, False], ids=["hermitian", "full-bin"])
def test_hermitian_forward_matches_jax(hermitian_pair, hermitian):
    """The port's forward with hermitian_dft on, and the full-bin one, at
    JAX's Hermitian forward's weights: relative L2 <= 1e-4 (the forward
    tests' tolerance, tests/test_torch_model.py), and within
    tests/test_hermitian.py's 2e-4 / 1e-4 of it."""
    flat, audio, want = hermitian_pair
    model = TorchModel(TorchConfig(encoders=("audio",), sep_num_tracks=4,
                                   hermitian_dft=hermitian))
    model.load_state_dict(from_flax(flat), strict=True)
    taps = {}
    with torch.no_grad():
        got = model(torch.from_numpy(audio), taps=taps).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_l2(got, want) <= 1e-4, rel_l2(got, want)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    assert taps["stft_mag"].shape[2] == 1024          # mirrored back to full bins


def _remat_batch(g, frame_hw):
    rng = np.random.RandomState(3)
    return {"ambix": torch.from_numpy((0.1 * rng.randn(2, g.snd_size, 4)).astype(np.float32)),
            "audio_mask": torch.ones((2, 4)),
            "video": torch.from_numpy(rng.randint(0, 256, (2, g.vid_dur, *frame_hw, 3),
                                                  dtype=np.uint8))}


def test_remat_train_step_equals_plain_step():
    """A train step with remat on equals the plain step from the same
    weights and batch: loss and gradients within 1e-6 relative (the same
    float32 operations on the CPU, recomputed), the params after Adam within
    1e-6, and the visual encoder's BN running averages moved once (equal to
    the plain step's, which is one momentum-0.99 update)."""
    frame_hw = (64, 128)
    results = {}
    for remat in (False, True):
        cfg = TorchConfig(sep_num_tracks=4, remat=remat)
        model = TorchModel(cfg, frame_hw=frame_hw).init_weights(
            torch.Generator().manual_seed(0))
        state = TrainState(model, make_optimizer(model.parameters()))
        batch = _remat_batch(cfg.geometry, frame_hw)
        before = model.state_dict()["video_encoder.conv1.bn.mean"].clone()
        losses, grads = [], []
        losses.append(float(train_step(state, batch, 1e-4)["total_loss"]))
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
        results[remat] = (losses, grads, {k: v.clone() for k, v in model.state_dict().items()},
                          before)
    (l_p, g_p, s_p, before), (l_r, g_r, s_r, _) = results[False], results[True]
    np.testing.assert_allclose(l_r, l_p, rtol=1e-6)
    for a, b in zip(g_r, g_p):
        assert float((a - b).norm() / b.norm()) <= 1e-6
    for key in s_p:
        torch.testing.assert_close(s_r[key], s_p[key], rtol=1e-6, atol=1e-9, msg=key)
    moved = s_r["video_encoder.conv1.bn.mean"]
    assert not torch.equal(moved, before)
    # one update: a second update in the recompute would move the averages
    # twice as far from where they started
    np.testing.assert_allclose(moved.numpy(), s_p["video_encoder.conv1.bn.mean"].numpy(),
                               rtol=1e-6, atol=1e-9)


def test_remat_leaves_forward_and_eval_unchanged():
    """Without autograd (a no_grad forward) remat takes no checkpoint; the
    output is the plain model's bit for bit."""
    cfg = TorchConfig(encoders=("audio",), sep_num_tracks=2)
    plain = TorchModel(cfg).init_weights(torch.Generator().manual_seed(1))
    remat = TorchModel(TorchConfig(encoders=("audio",), sep_num_tracks=2, remat=True))
    remat.load_state_dict(plain.state_dict())
    audio = torch.from_numpy(np.random.RandomState(4).randn(1, cfg.geometry.snd_size, 1)
                             .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(plain(audio), remat(audio))
