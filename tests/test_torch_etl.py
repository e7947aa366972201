"""The port's ETL (spatialaudiogen_tpu_torch.etl, utils.cmd, utils.io_video)
against the JAX package's copies it was made from, on the CPU.

Neither host has ffmpeg or network, so the ffmpeg / yt-dlp steps are held
to the JAX package's command lists (dry runs); the numpy and file-writing
steps (projections, PGM maps, reprojection, frame and wav extraction, the
audio power index, the flow jpg encoding) are held to JAX's outputs
exactly, byte for byte where they write files. Inputs are numpy-seeded.
"""

import os

import numpy as np
import pytest

from spatialaudiogen_tpu.etl import download as jdownload
from spatialaudiogen_tpu.etl import preprocess as jprep
from spatialaudiogen_tpu.etl import projections as jproj
from spatialaudiogen_tpu.etl import reproject as jrep
from spatialaudiogen_tpu_torch.etl import download as tdownload
from spatialaudiogen_tpu_torch.etl import preprocess as tprep
from spatialaudiogen_tpu_torch.etl import projections as tproj
from spatialaudiogen_tpu_torch.etl import reproject as trep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def files_of(folder) -> dict:
    """{relative path: bytes} of every file under `folder`."""
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            fn = os.path.join(root, name)
            with open(fn, "rb") as f:
                out[os.path.relpath(fn, folder)] = f.read()
    return out


@pytest.mark.parametrize("codec", ["aac", "opus", "vorbis"])
def test_ambisonics_cmd_matches_jax(codec):
    assert tprep.ambisonics_cmd("in.m4a", "out.wav", codec) == \
        jprep.ambisonics_cmd("in.m4a", "out.wav", codec)
    with pytest.raises(ValueError):
        tprep.ambisonics_cmd("in.xxx", "out.wav", "mp3")


@pytest.mark.parametrize("stereopsis, projection", [("MONO", "ER"), ("STEREO", "ER"),
                                                    ("MONO", "EAC"), ("STEREO", "EAC")])
def test_video_cmds_and_pgm_maps_match_jax(tmp_path, stereopsis, projection):
    """Command lists equal, and for EAC the remap PGMs equal byte for byte."""
    got, want = ({"dir": tmp_path / who} for who in ("port", "jax"))
    for mod, d in ((tprep, got), (jprep, want)):
        d["cmds"] = mod.video_cmds("in.mp4", stereopsis, projection,
                                   str(tmp_path / "out.mp4"), (28, 56), 10,
                                   in_shape=(60, 90), pgm_dir=str(d["dir"]))
    assert got["cmds"] == [[arg.replace(str(want["dir"]), str(got["dir"])) for arg in cmd]
                           for cmd in want["cmds"]]
    if projection == "EAC":
        assert files_of(got["dir"]) == files_of(want["dir"])
        assert len(files_of(got["dir"])) == 2


@pytest.mark.parametrize("stereopsis", ["MONO", "STEREO"])
def test_eac_maps_and_remap_match_jax(stereopsis):
    xmap, ymap = tproj.gen_eac2eqr_maps((120, 180), (45, 90), stereopsis)
    jx, jy = jproj.gen_eac2eqr_maps((120, 180), (45, 90), stereopsis)
    np.testing.assert_array_equal(xmap, jx)
    np.testing.assert_array_equal(ymap, jy)
    rng = np.random.RandomState(0)
    eqr = rng.rand(45, 90, 3)
    eac = tproj.equirect_to_eac(eqr, (120, 180), stereopsis)
    np.testing.assert_array_equal(eac, jproj.equirect_to_eac(eqr, (120, 180), stereopsis))
    np.testing.assert_array_equal(tproj.remap(eac, xmap, ymap), jproj.remap(eac, jx, jy))


def test_save_pgm_matches_jax(tmp_path):
    coords = np.random.RandomState(1).randint(0, 2 ** 16, (7, 11)).astype(np.uint16)
    for mod, name in ((tproj, "port.pgm"), (jproj, "jax.pgm")):
        with open(tmp_path / name, "w") as f:
            mod.save_pgm(f, coords, 2 ** 16 - 1)
    assert (tmp_path / "port.pgm").read_bytes() == (tmp_path / "jax.pgm").read_bytes()


@pytest.mark.parametrize("target", ["CubemapProjection", "SideBySideFisheyeProjection"])
def test_reproject_round_trips_match_jax(target):
    """equirect -> target -> equirect in both packages: equal arrays."""
    rng = np.random.RandomState(2)
    img = rng.rand(32, 64, 3)
    got = trep.reproject(trep.EquirectangularProjection(img), getattr(trep, target), (32, 64))
    want = jrep.reproject(jrep.EquirectangularProjection(img), getattr(jrep, target), (32, 64))
    if target == "CubemapProjection":
        for face in tproj.FACES:
            np.testing.assert_array_equal(got.faces[face], want.faces[face])
    else:
        np.testing.assert_array_equal(got.image, want.image)
    back = trep.reproject(got, trep.EquirectangularProjection, (32, 64))
    np.testing.assert_array_equal(
        back.image, jrep.reproject(want, jrep.EquirectangularProjection, (32, 64)).image)


def test_download_cmds_match_jax(tmp_path):
    """Custom partial tables (best-effort), the vendored tables over the
    real db list (pinned formats), low_res, and one stream's command."""
    db = tmp_path / "db.lst"
    db.write_text("abc123\nxyz789\n")
    fmts = tmp_path / "audio_formats.txt"
    fmts.write_text("abc123 251\n")
    kw = dict(audio_formats_fn=str(fmts), dry_run=True)
    assert tdownload.download_all(str(db), str(tmp_path), **kw) == \
        jdownload.download_all(str(db), str(tmp_path), **kw)
    full_db = os.path.join(REPO, "meta", "spatialaudiogen_db.lst")
    for low_res in (False, True):
        got = tdownload.download_all(full_db, str(tmp_path), low_res=low_res, dry_run=True)
        assert got and got == jdownload.download_all(full_db, str(tmp_path), low_res=low_res,
                                                     dry_run=True)
    assert tdownload.AUDIO_FORMATS_FN == jdownload.AUDIO_FORMATS_FN
    args = ("vid", str(tmp_path), None, "archive.txt", "video")
    assert tdownload.build_download_cmd(*args) == jdownload.build_download_cmd(*args)
    assert tdownload.extract_clip_cmd("a.mp4", "b.mp4", seek=1.5, duration=2.0) == \
        jdownload.extract_clip_cmd("a.mp4", "b.mp4", seek=1.5, duration=2.0)


def test_download_cli_dry_run_prints_jax_lines(tmp_path, capsys):
    db = tmp_path / "db.lst"
    db.write_text("-076WPWoCRE\n03UPyfDYf4g\n")
    out = {}
    for who, main in (("port", tdownload.main), ("jax", jdownload.main)):
        main([str(db), "--output_dir", str(tmp_path / "orig"), "--dry_run"])
        out[who] = capsys.readouterr().out
    assert out["port"] == out["jax"] and out["port"].count("yt-dlp") == 4


def test_hr_prep_dry_run_and_jobs_match_jax(tmp_path, capsys):
    """The worker's dry run (ambisonics remap, the 224x448 render and the
    1080x1920@30 HR render) prints JAX's commands; build_jobs gives JAX's
    jobs over a downloads dir."""
    job = {"audio_fn": "a.webm", "prep_audio_fn": str(tmp_path / "p-ambix.m4a"),
           "codec": "opus", "frames_dir": str(tmp_path / "frames"),
           "video_fn": "v.mp4", "prep_video_fn": str(tmp_path / "p-video.mp4"),
           "prep_hr_video_fn": str(tmp_path / "hr" / "p-video.mp4"),
           "stereopsis": "MONO", "projection": "EAC", "dry_run": True}
    printed = {}
    for who, mod in (("port", tprep), ("jax", jprep)):
        mod.preprocess_video_worker(dict(job))
        printed[who] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and "scale=1920:1080" in printed["port"]

    ids = ["-076WPWoCRE", "03UPyfDYf4g", "zzz_unknown"]
    orig = tmp_path / "orig"
    orig.mkdir()
    for yid in ids:
        (orig / f"{yid}.audio.f338.webm").write_bytes(b"x")
        (orig / f"{yid}.video.mp4").write_bytes(b"x")
    db = tmp_path / "db.lst"
    db.write_text("\n".join(ids) + "\n")
    args = (str(db), str(orig), str(tmp_path / "prep"), str(tmp_path / "frames"))
    kw = dict(dry_run=True, prep_hr_dir=str(tmp_path / "hr"), flow="farneback")
    assert tprep.build_jobs(*args, **kw) == jprep.build_jobs(*args, **kw)
    assert len(tprep.build_jobs(*args, **kw)) == 2


def test_extract_frames_and_audio_pow_match_jax(tmp_path):
    """The 1 s wav chunks, the jpg frames (both streams cut to the shorter)
    and audio_pow.lst, byte for byte."""
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav
    from spatialaudiogen_tpu_torch.utils.io_video import VideoWriter

    rng = np.random.RandomState(3)
    wav_fn = str(tmp_path / "prep.wav")
    save_wav(wav_fn, rng.randn(3 * 8000, 4) * 0.3, 8000)
    video_fn = str(tmp_path / "prep.mp4")
    writer = VideoWriter(video_fn, fps=10)
    for i in range(20):
        writer.write_frame(np.full((32, 64, 3), i * 10, np.uint8))
    writer.close()
    outs = {}
    for who, mod in (("port", tprep), ("jax", jprep)):
        frames_dir = str(tmp_path / who)
        assert mod.extract_frames(wav_fn, video_fn, frames_dir, rate=8000, video_rate=10) == 2
        mod.compute_audio_pow(frames_dir, rate=8000)
        outs[who] = files_of(frames_dir)
    assert outs["port"] == outs["jax"]
    assert sum(name.endswith(".wav") for name in outs["port"]) == 2
    assert sum(name.endswith(".jpg") for name in outs["port"]) >= 19


def test_flow_encoding_matches_jax(tmp_path):
    """flow_frame_rgb's bytes and limits (the reference's atan2 + pi angle,
    the 0.005 magnitude gate, the clamped range) and compress_flow's jpgs
    and flow_limits.npy, byte for byte."""
    rng = np.random.RandomState(4)
    flow = rng.randn(3, 16, 24, 2).astype(np.float32) * 3
    flow[0, :4] = 1e-4
    flow[2] = 0.1                                   # near-constant: the range clamp
    for frame in flow:
        got, want = tprep.flow_frame_rgb(frame), jprep.flow_frame_rgb(frame)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for who, mod in (("port", tprep), ("jax", jprep)):
        mod.compress_flow(flow, str(tmp_path / who))
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")


def test_preprocess_pool_refuses_device_flow(tmp_path):
    """flow='tpu' (the solver on a torch device) must not enter a worker pool
    of more than one: CUDA cannot be initialised in a forked worker. The
    CLI runs it as a serial pass in the parent instead."""
    job = {"audio_fn": "x", "prep_audio_fn": "x", "codec": "opus",
           "frames_dir": str(tmp_path / "f"), "flow": "tpu"}
    with pytest.raises(AssertionError, match="worker pool"):
        tprep.preprocess_all([job, job], n_workers=2)


def test_preprocess_cli_device_flow_post_pass(tmp_path, capsys):
    """sag-torch-preprocess --flow tpu --device cpu over prepared streams
    (the ffmpeg stages skip: their outputs exist): the pool extracts the
    frames, then the parent solves the flow on the CPU, writing the flow
    layout the feeder reads."""
    from spatialaudiogen_tpu_torch.utils.io_audio import save_wav
    from spatialaudiogen_tpu_torch.utils.io_video import VideoWriter

    yid = "00Eu5i2mTbw"                  # an ER video: no ffprobe needed
    orig, prep, frames = (tmp_path / name for name in ("orig", "prep", "frames"))
    for d in (orig, prep):
        d.mkdir()
    (orig / f"{yid}.audio.f251.webm").write_bytes(b"x")
    (orig / f"{yid}.video.mp4").write_bytes(b"x")
    rng = np.random.RandomState(5)
    save_wav(str(prep / f"{yid}-ambix.m4a"), rng.randn(2 * 48000, 4) * 0.3, 48000)
    writer = VideoWriter(str(prep / f"{yid}-video.mp4"), fps=10)
    ys, xs = np.mgrid[0:48, 0:64]
    for i in range(20):                  # 2 s at 10 fps, as long as the audio
        blob = np.exp(-(((xs - 16 - 1.5 * i) ** 2 + (ys - 24) ** 2) / 40.0))
        writer.write_frame(np.repeat((blob * 255).astype(np.uint8)[..., None], 3, -1))
    writer.close()
    db = tmp_path / "db.lst"
    db.write_text(yid + "\n")
    tprep.main([str(db), "--orig_dir", str(orig), "--output_prep_dir", str(prep),
                "--output_frames_dir", str(frames), "--num_workers", "1", "--flow", "tpu",
                "--device", "cpu"])
    assert f"flow (tpu): {frames / yid}" in capsys.readouterr().out
    flow_dir = frames / yid / "flow"
    n_jpg = len(os.listdir(frames / yid / "video"))
    assert n_jpg >= 19 and len([f for f in os.listdir(flow_dir) if f.endswith(".jpg")]) == n_jpg
    assert np.load(flow_dir / "flow_limits.npy").shape == (n_jpg, 2)


def test_run_system_cmd_dry_run_matches_jax(capsys):
    from spatialaudiogen_tpu.utils.cmd import run_system_cmd as jrun
    from spatialaudiogen_tpu_torch.utils.cmd import run_system_cmd

    cmd = ["ffmpeg", "-y", "-i", "a b.wav", "out.wav"]
    assert run_system_cmd(cmd, dry_run=True) == jrun(cmd, dry_run=True)
    assert run_system_cmd("echo  x", dry_run=True) == jrun("echo  x", dry_run=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[2] == out[3]
    assert run_system_cmd(["true"]) == ("", "")
    with pytest.raises(RuntimeError, match="Command failed"):
        run_system_cmd(["false"])
