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


def test_cli_compute_dtype_bfloat16(setup, tmp_path):
    """--compute_dtype bfloat16 deploys the float32 checkpoint with the
    conv/FC products in bfloat16: the W passthrough is the input bit for
    bit, and the predictions are within bf16 rounding of the float32 ones:
    3.5e-2 relative L2 on this clip, whose near-constant frames let the
    visual encoder's batch-statistics BatchNorm magnify rounding (see
    test_deploy_matches_jax); limit 0.1. At least 1e-3: a port that ran
    the products in float32 would differ from the float32 deploy only by
    the bf16 mask's rounding, two orders of magnitude less."""
    model_dir, clip, _, _, exact, _ = setup
    ambi = cli_main([model_dir, clip, "--device", "cpu", "--batch_size", str(BATCH),
                     "--deploy_start", str(START), "--deploy_duration", str(DURATION),
                     "--compute_dtype", "bfloat16", "--f32_fetch",
                     "--output_fn", str(tmp_path / "unused")])
    assert ambi.shape == exact.shape and np.isfinite(ambi).all()
    np.testing.assert_array_equal(ambi[:, 0], exact[:, 0])
    err = rel_l2(ambi[:, 1:], exact[:, 1:])
    assert 1e-3 <= err <= 0.1, err


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


def test_flow_config_builds_the_flow_encoder(tmp_path):
    """A model dir trained with flow loads into MonoToAmbix: its own
    flow_encoder ResNet18 beside the video encoder, every params.npz key
    taken (strict), and deploy routed to the per-window host path
    (tests/test_torch_flow.py holds that path against the JAX engine)."""
    from spatialaudiogen_tpu_torch.config import TrainConfig as TorchTrainConfig
    from spatialaudiogen_tpu_torch.models.convert import save_params
    from spatialaudiogen_tpu_torch.models.sptaudiogen import SptAudioGen as TorchModel

    cfg = TorchTrainConfig(model_dir=str(tmp_path), encoders=("audio", "video", "flow"),
                           num_sep_tracks=2, frame_hw=FRAME_HW)
    cfg.save()
    model = TorchModel(cfg.model_config(), frame_hw=FRAME_HW).init_weights(
        torch.Generator().manual_seed(0))
    save_params(str(tmp_path), model.state_dict())
    engine = MonoToAmbix(str(tmp_path), batch_size=2, device="cpu")
    names = dict(engine.model.named_children())
    assert {"video_encoder", "flow_encoder"} <= set(names)
    assert names["flow_encoder"] is not names["video_encoder"]
    sd = engine.model.state_dict()
    assert torch.equal(sd["flow_encoder.conv1.conv.weight"],
                       model.state_dict()["flow_encoder.conv1.conv.weight"])


VIDEO_CASES = {                       # the flags after VIDEO
    "video": [],                     # VIDEO alone: deploy, no video written
    "save_video": ["--save_video"],  # binaural W+-Y stereo mp4
    "overlay_map": ["--save_video", "--overlay_map"],
    "VR": ["--save_video", "--VR"],  # ambisonics + SA3D + spherical video
}


@pytest.fixture(scope="module")
def source_video(tmp_path_factory):
    """A 1 s, 30 fps mp4 that cv2 reads (written with cv2)."""
    from spatialaudiogen_tpu_torch.utils.io_video import VideoWriter

    fn = str(tmp_path_factory.mktemp("source_video") / "video.mp4")
    writer = VideoWriter(fn, fps=30)
    ys, xs = np.mgrid[0:FRAME_HW[0], 0:FRAME_HW[1]]
    for i in range(30):
        frame = np.stack([(xs * 2 + i * 4) % 256, (ys * 3) % 256, np.full_like(xs, 90)], -1)
        writer.write_frame(frame.astype(np.uint8))
    writer.close()
    return fn


class _JaxEngineStandIn:
    """Takes the JAX MonoToAmbix's place under the JAX cli.deploy: it returns
    the port's prediction, so both CLIs' video paths get one input."""

    def __init__(self, ambi, cfg):
        self.ambi, self.cfg, self.restored_step = ambi, cfg, 0

    def deploy(self, *args, **kwargs):
        return self.ambi


def _video_frames(fn) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(fn)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,))


@pytest.mark.parametrize("case", list(VIDEO_CASES))
def test_cli_video_outputs_match_jax(setup, source_video, tmp_path, monkeypatch, case):
    """The reference's invocation (VIDEO, --save_video, --overlay_map, --VR)
    runs through the mux, as the JAX CLI does: with a stub ffmpeg first on
    PATH (tests/ffmpeg_stub.py: it records its argv and copies or writes
    its output), the port's cli.deploy on the CPU and the JAX cli.deploy
    (its engine replaced by the port's prediction) run the same ffmpeg
    commands, mux the same audio (the W+-Y stereo, or the ambisonics under
    --VR) and the same frames (the power-map overlay, written with cv2),
    and write the same file (SA3D and spherical metadata under --VR); the
    trimmed video and the wav are removed. VIDEO alone writes no video."""
    import ffmpeg_stub

    from spatialaudiogen_tpu.cli import deploy as jax_cli
    from spatialaudiogen_tpu.deploy import deploy as jax_deploy
    from spatialaudiogen_tpu.utils import jax_setup
    from spatialaudiogen_tpu_torch.deploy.mux import binauralize_stereo
    from spatialaudiogen_tpu_torch.deploy.sa3d import SPHERICAL_UUID, parse_top_level

    model_dir, clip = setup[:2]
    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda *a, **k: None)
    path = os.environ["PATH"]
    runs = {}
    for who in ("port", "jax"):
        stub = ffmpeg_stub.install(tmp_path / who / "bin")
        monkeypatch.setenv("PATH", stub + os.pathsep + path)
        out = str(tmp_path / who / "out.mp4")
        argv = [model_dir, clip, source_video] + VIDEO_CASES[case] + [
            "--output_fn", out, "--deploy_start", str(START), "--deploy_duration",
            str(DURATION), "--batch_size", str(BATCH)]
        if who == "port":
            ambi = cli_main(argv + ["--device", "cpu"])
            cfg = TrainConfig.load(model_dir)
            monkeypatch.setattr(jax_deploy, "MonoToAmbix",
                                lambda *a, **k: _JaxEngineStandIn(ambi, cfg))
        else:
            jax_cli.main(argv)
        runs[who] = (stub, out, [ffmpeg_stub.normalised(c, out)
                                 for c in ffmpeg_stub.calls(stub)])

    (port_bin, port_out, port_calls), (jax_bin, jax_out, jax_calls) = runs["port"], runs["jax"]
    assert port_calls == jax_calls
    if case == "video":
        assert port_calls == [] and not os.path.exists(port_out)
        return
    # trim, split audio, split video, mux
    assert [c[:4] for c in port_calls] == [["-y", "-ss", str(START), "-i"],
                                           ["-y", "-i", "<ambix.wav>", "-vn"],
                                           ["-y", "-i", "<trimmed.mp4>", "-an"],
                                           ["-y", "-i", port_calls[3][2], "-i"]]
    raw = ffmpeg_stub.calls(port_bin)
    assert not os.path.exists(raw[0][-1]) and not os.path.exists(raw[1][2])
    with open(os.path.join(port_bin, "mix4_audio.wav"), "rb") as f, \
            open(os.path.join(jax_bin, "mix4_audio.wav"), "rb") as g:
        assert f.read() == g.read()
    mixed, rate = load_wav(os.path.join(port_bin, "mix4_audio.wav"))
    assert rate == 48000
    if case == "VR":
        np.testing.assert_allclose(mixed, ambi, rtol=0, atol=1.5 / 32768)
        moov = next(b for b in parse_top_level(open(port_out, "rb").read()) if b.type == b"moov")
        (sa3d,) = moov.find_all(b"SA3D")
        assert sa3d.payload[2:6] == (1).to_bytes(4, "big")          # ambisonic order 1
        assert any(u.payload.startswith(SPHERICAL_UUID) for u in moov.find_all(b"uuid"))
    else:
        np.testing.assert_allclose(mixed, binauralize_stereo(ambi), rtol=0, atol=2 / 32768)
        assert open(port_out, "rb").read() == ffmpeg_stub.fake_mp4()
    assert open(port_out, "rb").read() == open(jax_out, "rb").read()
    frames = _video_frames(os.path.join(port_bin, "mix4_video.mp4"))
    np.testing.assert_array_equal(frames, _video_frames(os.path.join(jax_bin, "mix4_video.mp4")))
    source = _video_frames(source_video)
    if case == "overlay_map":
        assert frames.shape[1:] == source.shape[1:] and len(frames) >= 5
    else:
        np.testing.assert_array_equal(frames, source)


def test_cli_refuses_save_video_without_video(tmp_path):
    """As the JAX CLI asserts, --save_video needs VIDEO: ValueError before
    any model is loaded (the model dir does not exist)."""
    with pytest.raises(ValueError, match="VIDEO"):
        cli_main([str(tmp_path / "model"), str(tmp_path / "clip"), "--save_video",
                  "--device", "cpu"])


def test_cli_refuses_n_data_that_cannot_shard_the_batch(tmp_path):
    """--n_data runs (tests/test_torch_sharded.py), but as the JAX engine
    asserts, the batch must divide over the ranks: ValueError before any
    model is loaded (the model dir does not exist)."""
    argv = [str(tmp_path / "model"), str(tmp_path / "clip"), "--n_data", "2",
            "--batch_size", "3", "--device", "cpu"]
    with pytest.raises(ValueError, match="divide"):
        cli_main(argv)


def test_cli_parses_the_reference_invocation():
    from spatialaudiogen_tpu_torch.cli.deploy import parse_arguments

    args = parse_arguments(["model", "clip", "video.mp4", "--save_ambix", "--save_video",
                            "--overlay_map", "--VR", "--n_data", "1"])
    assert args.video == "video.mp4" and args.save_video and args.overlay_map and args.VR
    assert args.n_data == 1 and parse_arguments(["model", "clip"]).video == ""
