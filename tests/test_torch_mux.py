"""The port's 360-video packaging (deploy.mux, deploy.sa3d, cli.spatialmedia,
cli.power_map) against the JAX package's, on the CPU.

The MP4 box editor's output is held to JAX's byte for byte (SA3D and
spherical-video boxes, injected files, the print mode's lines); the mux's
dry-run log line for line (its temporary folder's name aside); the W+-Y
stereo and the power-map frames exactly. ffmpeg runs in no test here:
tests/test_torch_deploy.py drives the mux end to end through a stub.
"""

import re
import struct

import numpy as np
import pytest
from ffmpeg_stub import fake_mp4

from spatialaudiogen_tpu.deploy import mux as jmux
from spatialaudiogen_tpu.deploy import sa3d as jsa3d
from spatialaudiogen_tpu_torch.deploy import mux as tmux
from spatialaudiogen_tpu_torch.deploy import sa3d as tsa3d


@pytest.mark.parametrize("order", [1, 2, 3])
def test_sa3d_box_matches_jax(order):
    assert tsa3d.make_sa3d_box(order=order).serialize() == \
        jsa3d.make_sa3d_box(order=order).serialize()
    cmap = [0, 2, 1, 3]
    assert tsa3d.make_sa3d_box(channel_map=cmap).serialize() == \
        jsa3d.make_sa3d_box(channel_map=cmap).serialize()


@pytest.mark.parametrize("stereo", ["none", "top-bottom", "left-right"])
def test_spherical_box_matches_jax(stereo):
    assert tsa3d.make_spherical_uuid_box(stereo).serialize() == \
        jsa3d.make_spherical_uuid_box(stereo).serialize()


@pytest.mark.parametrize("audio, video, order, stereo", [
    (True, True, 1, "none"), (True, False, 2, "none"), (False, True, 1, "top-bottom")])
def test_injection_matches_jax_byte_for_byte(tmp_path, audio, video, order, stereo):
    """inject_spatial_metadata (moov before mdat: chunk offsets shifted) and
    inject_file give JAX's bytes; the box tree parses back, injection is
    idempotent, and the print mode describes the file as JAX does."""
    data = fake_mp4()
    got = tsa3d.inject_spatial_metadata(data, audio, video, order, stereo)
    assert got == jsa3d.inject_spatial_metadata(data, audio, video, order, stereo)
    assert tsa3d.inject_spatial_metadata(got, audio, video, order, stereo) == got
    moov = tsa3d.parse_top_level(got)[1]
    assert len(moov.find_all(b"SA3D")) == int(audio)
    src = tmp_path / "in.mp4"
    src.write_bytes(data)
    for mod, name in ((tsa3d, "port.mp4"), (jsa3d, "jax.mp4")):
        mod.inject_file(str(src), str(tmp_path / name), audio, video, order, stereo)
    assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "jax.mp4").read_bytes() == got
    fn = str(tmp_path / "port.mp4")
    assert tsa3d.describe_file(fn) == jsa3d.describe_file(fn)


def test_describe_malformed_and_bare_files_match_jax(tmp_path):
    notmp4 = tmp_path / "x.wav"
    notmp4.write_bytes(b"RIFF" + b"\x00" * 40)
    bare = tmp_path / "bare.mp4"
    bare.write_bytes(fake_mp4())
    good = tsa3d.inject_spatial_metadata(fake_mp4(), True, False)
    idx = good.find(b"SA3D")
    old = struct.unpack(">I", good[idx - 4: idx])[0]
    trunc = tmp_path / "trunc.mp4"
    trunc.write_bytes(good[:idx - 4] + struct.pack(">I", 12) + b"SA3D" + b"\x00" * 4
                      + good[idx - 4 + old:])
    for fn in (notmp4, bare, trunc):
        assert tsa3d.describe_file(str(fn)) == jsa3d.describe_file(str(fn))
    assert "not an MP4" in tsa3d.describe_file(str(notmp4))[0]
    assert sum("no spatial metadata" in line for line in tsa3d.describe_file(str(bare))) == 2


@pytest.mark.parametrize("inject, overlay, binaural", [
    (True, False, False), (False, False, True), (True, True, False), (False, True, True)])
def test_mux_dry_run_log_matches_jax(tmp_path, inject, overlay, binaural):
    """gen_360video(dry_run=True): JAX's ffmpeg commands and steps, line for
    line (each run's temporary folder replaced by a placeholder)."""
    def log(mod):
        lines = mod.gen_360video("a.wav", "v.mp4", str(tmp_path / "out.mp4"),
                                 inject_meta=inject, overlay_map=overlay,
                                 binauralize=binaural, dry_run=True)
        return [re.sub(r"\S*/sag360_[^/]+/", "<tmp>/", line) for line in lines]

    got = log(tmux)
    assert got == log(jmux)
    assert sum(line.startswith("ffmpeg") for line in got) == 3


def test_binauralize_stereo_matches_jax():
    amb = np.random.RandomState(0).randn(1000, 4)
    got = tmux.binauralize_stereo(amb)
    np.testing.assert_array_equal(got, jmux.binauralize_stereo(amb))
    assert got.shape == (1000, 2) and np.abs(got).max() == pytest.approx(0.95)


def test_spatialmedia_cli_matches_jax(tmp_path, capsys):
    """Inject mode writes JAX's file; print mode prints JAX's description."""
    from spatialaudiogen_tpu.cli.spatialmedia import main as jax_main
    from spatialaudiogen_tpu_torch.cli.spatialmedia import main

    src = tmp_path / "in.mp4"
    src.write_bytes(fake_mp4())
    printed = {}
    for who, fn in (("port", main), ("jax", jax_main)):
        out = tmp_path / f"{who}.mp4"
        fn(["-i", "--spatial-audio", "--stereo", "left-right", "--ambi_order", "2",
            str(src), str(out)])
        fn([str(out), str(src)])
        printed[who] = capsys.readouterr().out.replace(str(out), "<out>")
    assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "jax.mp4").read_bytes()
    assert printed["port"] == printed["jax"]
    assert "SA3D order=2" in printed["port"] and "left-right" in printed["port"]
    with pytest.raises(SystemExit):
        main(["-i", str(src)])


def test_power_map_cli_matches_jax(tmp_path, capsys):
    """cli.power_map renders the same map frames as JAX's (decoded with cv2)
    from a first-order wav of a source circling the listener."""
    import cv2

    from spatialaudiogen_tpu.cli.power_map import main as jax_main
    from spatialaudiogen_tpu_torch.cli.power_map import main
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

    rate = 8000
    n = 2 * rate
    rng = np.random.RandomState(1)
    s = 0.3 * rng.randn(n)
    az = np.linspace(0, 2 * np.pi, n)
    wav = str(tmp_path / "scene.wav")
    save_wav(wav, np.stack([s, s * np.sin(az), 0.1 * s, s * np.cos(az)], 1), rate)
    frames = {}
    for who, fn in (("port", main), ("jax", jax_main)):
        out = str(tmp_path / f"{who}.mp4")
        fn([wav, out, "--angular_res", "20", "--scale", "2"])
        cap = cv2.VideoCapture(out)
        stack = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            stack.append(frame)
        frames[who] = np.stack(stack)
    assert len(frames["port"]) >= 15
    np.testing.assert_array_equal(frames["port"], frames["jax"])
    assert capsys.readouterr().out.count("map frames") == 2
