"""The PyTorch deploy engine and CLI against the JAX MonoToAmbix.

A JAX model dir (reduced flagship: audio+video, unet_mask with 8 tracks,
64x128 frames) is written with create_train_state + save_checkpoint and
exported with tools/export_torch_weights.py; both engines then deploy the
same synthetic clip at batch 3 over 5 windows, so the last batch carries a
pad lane.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from spatialaudiogen_tpu.config import TrainConfig
from spatialaudiogen_tpu.data.synthetic import make_synthetic_dataset
from spatialaudiogen_tpu.deploy.deploy import MonoToAmbix as JaxMonoToAmbix
from spatialaudiogen_tpu.deploy.deploy import yuv420_planes_to_rgb01 as jax_yuv_to_rgb
from spatialaudiogen_tpu.models import SptAudioGen
from spatialaudiogen_tpu.train.checkpoint import save_checkpoint
from spatialaudiogen_tpu.train.lr import make_optimizer
from spatialaudiogen_tpu.train.state import create_train_state
from spatialaudiogen_tpu.utils.io_audio import load_wav
from spatialaudiogen_tpu_torch.cli.deploy import main as cli_main
from spatialaudiogen_tpu_torch.deploy.deploy import MonoToAmbix, yuv420_planes_to_rgb01

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import export  # noqa: E402

FRAME_HW = (64, 128)
START, DURATION, BATCH = 0.5, 0.5, 3


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torchdeploydb"))
    make_synthetic_dataset(root, n_videos=1, duration=4.0, frame_hw=FRAME_HW, seed=5)
    model_dir = str(tmp_path_factory.mktemp("torchdeploymodel"))
    cfg = TrainConfig(db_dir=root, model_dir=model_dir, encoders=("audio", "video"),
                      separation="unet_mask", num_sep_tracks=8, frame_hw=FRAME_HW,
                      n_data=1)
    cfg.save()
    g = cfg.model_config().geometry
    example = {"ambix": np.zeros((1, g.snd_size, 4), np.float32),
               "audio_mask": np.ones((1, 4), np.float32),
               "video": np.zeros((1, g.vid_dur) + FRAME_HW + (3,), np.float32)}
    state = create_train_state(SptAudioGen(cfg.model_config()), make_optimizer(),
                               jax.random.PRNGKey(3), example)
    save_checkpoint(model_dir, state, 1)
    export(model_dir)
    clip = os.path.join(root, "synth000")
    ref = JaxMonoToAmbix(model_dir, batch_size=BATCH, f16_fetch=False).deploy(
        clip, START, DURATION)
    engine = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu", f16_fetch=False)
    exact = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu", f16_fetch=False)
    exact.model.double()
    return (model_dir, clip, ref, engine, engine.deploy(clip, START, DURATION),
            exact.deploy(clip, START, DURATION))


def test_deploy_matches_jax(setup):
    """Same shape, the W passthrough bit for bit, and predictions that agree
    with the JAX engine and with a float64 run of the same weights.

    The synthetic frames are a blob on a flat background, so the visual
    encoder's batch-statistics BatchNorm divides by small variances and
    magnifies float32 rounding. The JAX engine's own float32 error on this
    clip, against the float64 run, is about 1.2e-4 relative L2 (XLA:CPU
    sums the batch moments in float32); the port's is about 5e-6. Hence
    port vs float64 <= 2e-5, JAX vs float64 and port vs JAX <= 2.5e-4."""
    _, _, ref, _, got, f64 = setup
    rate = 48000
    assert got.shape == ref.shape == f64.shape == (int(DURATION * rate), 4)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    errs = {"port-f64": rel_l2(got[:, 1:], f64[:, 1:]),
            "jax-f64": rel_l2(ref[:, 1:], f64[:, 1:]),
            "port-jax": rel_l2(got[:, 1:], ref[:, 1:])}
    assert errs["port-f64"] <= 2e-5, errs
    assert errs["jax-f64"] <= 2.5e-4 and errs["port-jax"] <= 2.5e-4, errs


def test_w_passthrough_is_the_input(setup):
    from spatialaudiogen_tpu.data.readers import AudioChunkReader

    _, clip, _, _, got, _ = setup
    reader = AudioChunkReader(os.path.join(clip, "ambix"), 48000, 1)
    np.testing.assert_array_equal(got[:, 0], reader.get(START, got.shape[0])[:, 0])


def test_f16_fetch_tracks_f32(setup):
    """float16 copy-back stays within half-precision rounding (2e-3 of the
    peak) of the float32 one."""
    model_dir, clip, _, _, exact, _ = setup
    fast = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu").deploy(
        clip, START, DURATION)
    np.testing.assert_array_equal(fast[:, 0], exact[:, 0])
    scale = np.abs(exact[:, 1:]).max()
    assert np.abs(fast[:, 1:] - exact[:, 1:]).max() / scale < 2e-3


def test_cli_save_ambix(setup, tmp_path):
    """The CLI's PCM16 wav is the engine's deploy result (RGB frame upload
    forced on both) up to PCM16 rounding: written as round(x*32767), read
    back as int16/32768, so within 1.5/32768 for |x| <= 1."""
    model_dir, clip, _, _, _, _ = setup
    out = str(tmp_path / "pred")
    cli_main([model_dir, clip, "--save_ambix", "--output_fn", out, "--device", "cpu",
              "--batch_size", str(BATCH), "--deploy_start", str(START),
              "--deploy_duration", str(DURATION), "--rgb_frames", "--f32_fetch"])
    wav, rate = load_wav(out + ".wav")
    want = MonoToAmbix(model_dir, batch_size=BATCH, device="cpu", yuv_frames=False,
                       f16_fetch=False).deploy(clip, START, DURATION)
    assert rate == 48000 and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=0, atol=1.5 / 32768)


def test_crossfade_runs(setup):
    _, clip, _, engine, got, _ = setup
    xfade = engine.deploy(clip, START, DURATION, crossfade=True)
    assert xfade.shape[0] <= got.shape[0] and xfade.shape[1] == got.shape[1]
    assert np.isfinite(xfade).all()


def test_yuv420_conversion_matches_jax():
    rng = np.random.RandomState(0)
    planes = rng.randint(0, 256, (2, 1, 48, 64)).astype(np.uint8)   # H = 32
    ref = np.asarray(jax_yuv_to_rgb(planes, 32))
    got = yuv420_planes_to_rgb01(torch.from_numpy(planes), 32).numpy()
    assert got.shape == ref.shape == (2, 1, 32, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_flow_config_not_ported(tmp_path):
    with open(tmp_path / "train-params.json", "w") as f:
        json.dump({"encoders": ["audio", "video", "flow"]}, f)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MonoToAmbix(str(tmp_path), device="cpu")
