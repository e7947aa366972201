"""The port's loss-side DFT, evaluation metrics, training loss and L2
regularizer against the JAX package's, on the same inputs.

Tolerances: the STFTs are float32 matmuls summed in another order (atol
1e-4 on spectra of unit-scale signals, as tests/test_torch_dft.py); the
metrics are reductions of those, held at rel 1e-5 (lsd/snr, logs of ratios,
at abs 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.models import SptAudioGen as JaxModel
from spatialaudiogen_tpu.models import SptAudioGenConfig as JaxConfig
from spatialaudiogen_tpu.models.layers import l2_regularization as jax_l2
from spatialaudiogen_tpu.models.metrics import evaluation_metrics as jax_metrics
from spatialaudiogen_tpu.models.metrics import training_loss as jax_training_loss
from spatialaudiogen_tpu.ops.dft import stft_for_loss_real as jax_stft_for_loss
from spatialaudiogen_tpu.ops.dft import stft_real as jax_stft_real
from spatialaudiogen_tpu_torch.config import SptAudioGenConfig
from spatialaudiogen_tpu_torch.models.convert import from_flax
from spatialaudiogen_tpu_torch.models.layers import l2_regularization
from spatialaudiogen_tpu_torch.models.metrics import evaluation_metrics, training_loss
from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen
from spatialaudiogen_tpu_torch.ops.dft import stft_for_loss_real, stft_real

RATE = 48000


def _pred_target(seed=0, b=4, n=4800):
    rng = np.random.RandomState(seed)
    target = (0.3 * rng.randn(b, n, 3)).astype(np.float32)
    pred = (target + 0.1 * rng.randn(b, n, 3)).astype(np.float32)
    mask = np.ones((b, 3), np.float32)
    mask[1, 1] = 0.0                   # a WXY clip: Z masked
    return pred, target, mask


@pytest.mark.parametrize("window, overlap", [(1200, 2), (1200, 1), (1024, 4)])
def test_stft_for_loss_real_matches_jax(window, overlap):
    _, target, _ = _pred_target()
    want = jax_stft_for_loss(jnp.asarray(target), window, overlap)
    got = stft_for_loss_real(torch.from_numpy(target), window, overlap)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_full_framing_stft_matches_jax():
    """stft_real without a frame range at the LSD metric's 1200 window."""
    _, target, _ = _pred_target(b=2)
    x = target.transpose(0, 2, 1)
    want = jax_stft_real(jnp.asarray(x), 1200, 2)
    got = stft_real(torch.from_numpy(np.ascontiguousarray(x)), 1200, 2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def metric_pair():
    pred, target, mask = _pred_target(seed=1)
    want, want_ps = jax_metrics(jnp.asarray(pred), jnp.asarray(target),
                                jnp.asarray(mask), RATE)
    got, got_ps = evaluation_metrics(*(torch.from_numpy(a) for a in (pred, target, mask)),
                                     RATE)
    return want, want_ps, got, got_ps


def test_evaluation_metrics_match_jax(metric_pair):
    want, _, got, _ = metric_pair
    assert set(got) == set(want)
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-5), k


@pytest.mark.parametrize("key", ["stft", "lsd", "mse", "snr"])
def test_per_sample_metrics_match_jax(metric_pair, key):
    _, want_ps, _, got_ps = metric_pair
    np.testing.assert_allclose(got_ps[key].numpy(), np.asarray(want_ps[key]),
                               rtol=1e-5, atol=1e-5)


def test_all_channels_masked_divides_by_one():
    """num_masked = max(sum(mask), 1): a channel no clip carries scores 0,
    not NaN."""
    pred, target, mask = _pred_target(seed=2)
    mask[:, 1] = 0.0
    got, _ = evaluation_metrics(*(torch.from_numpy(a) for a in (pred, target, mask)), RATE)
    assert float(got["stft/Z"]) == 0.0
    assert all(np.isfinite(float(v)) for v in got.values())


@pytest.fixture(scope="module")
def small_models():
    """The same JAX-initialised weights in both packages (4 tracks, 32x64
    frames: only the kernels' values matter here)."""
    cfg = JaxConfig(encoders=("audio", "video"), separation="unet_mask", sep_num_tracks=4)
    g = cfg.geometry
    audio = np.zeros((1, g.snd_size, 1), np.float32)
    video = np.zeros((1, g.vid_dur, 32, 64, 3), np.float32)
    jmodel = JaxModel(cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), audio, video, train=False)
    flat = {"/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]}
    model = SptAudioGen(SptAudioGenConfig(sep_num_tracks=4), frame_hw=(32, 64))
    model.load_state_dict(from_flax(flat), strict=True)
    return jmodel, variables, model


def test_l2_regularization_matches_jax(small_models):
    jmodel, variables, model = small_models
    want = float(jax_l2(variables["params"], 5e-4, exclude=jmodel.no_decay_paths()))
    got = l2_regularization(model, 5e-4, exclude=model.no_decay_paths()).item()
    assert got == pytest.approx(want, rel=1e-5)
    # kernels only (no bias or BN parameter), the localization output out
    assert model.no_decay_paths() == ("localization.fc3",)
    exact = sum(float((p.detach().double() ** 2).sum()) for n, p in model.named_parameters()
                if n.endswith(".weight") and not n.startswith("localization.fc3."))
    assert got == pytest.approx(0.5 * 5e-4 * exact, rel=1e-5)


def test_training_loss_matches_jax(small_models):
    jmodel, variables, model = small_models
    pred, target, mask = _pred_target(seed=3)
    want_total, want = jax_training_loss(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), RATE,
        params=variables["params"], decay_exclude=jmodel.no_decay_paths())
    got_total, got = training_loss(
        *(torch.from_numpy(a) for a in (pred, target, mask)), RATE, model=model,
        decay_exclude=model.no_decay_paths())
    assert float(got_total.detach()) == pytest.approx(float(want_total), rel=1e-5)
    for k in ("stft/mse", "regularization", "total_loss"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
