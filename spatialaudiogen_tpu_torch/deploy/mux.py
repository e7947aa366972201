"""360 video packaging: split/overlay/binauralize/mix/inject (the port's
copy of spatialaudiogen_tpu.deploy.mux).

Parity with reference myutils.gen_360video (myutils.py:225-318):
  1. split the predicted-ambisonics wav and source video (ffmpeg)
  2. optional spherical power-map overlay (our SphericalAmbisonicsVisualizer,
     batched matmul maps; frames handled by OpenCV, no ffmpeg needed)
  3. non-VR path: binauralize to W+Y / W-Y stereo
  4. mux audio+video (ffmpeg)
  5. VR path: inject SA3D + spherical metadata (our own box editor,
     deploy.sa3d — replaces the vendored spatial-media subprocess)

ffmpeg is only needed for steps 1/4; every command is built by
`ffmpeg_commands`-style helpers so the pipeline is testable without the
binary (pass dry_run=True to collect the commands instead of running).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.maps import SphericalAmbisonicsVisualizer
from spatialaudiogen_tpu_torch.deploy.sa3d import inject_file
from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, save_wav


def _run(cmd: list, dry_run: bool, log: list):
    log.append(" ".join(cmd))
    if dry_run:
        return
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(
            f"'{cmd[0]}' not found on PATH — the mux pipeline needs ffmpeg for "
            "stream splitting/muxing. Re-run with dry_run=True to inspect the "
            "commands, or install ffmpeg.")
    subprocess.run(cmd, check=True, capture_output=True)


def overlay_power_map(ambix: np.ndarray, snd_rate: float, video_in: str,
                      video_out: str, subsample: int = 5):
    """Blend windowed RMS direction maps over the video frames
    (myutils.py:246-283 semantics: 2 Hz maps interpolated 5x, YlOrRd map)."""
    import cv2
    from matplotlib import pyplot as plt

    from spatialaudiogen_tpu_torch.utils.io_video import BasicVideoReader, VideoWriter

    reader = BasicVideoReader(video_in, rate=10)
    writer = VideoWriter(video_out, reader.fps if reader.fps else 10)
    vis = SphericalAmbisonicsVisualizer(ambix[::subsample], snd_rate / subsample,
                                        window=subsample / reader.fps, angular_res=5.0)
    cmap = plt.cm.YlOrRd(np.linspace(0, 1, 256))[:, :3]

    def norm(r):
        return (r - r.min()) / (r.max() - r.min() + 0.005)

    cur = vis.get_next_frame()
    if cur is None:
        raise ValueError("audio too short for overlay maps")
    cur = norm(cur)
    hw = reader.frame_shape[:2]
    while True:
        prev, nxt = cur, vis.get_next_frame()
        if nxt is None:
            break
        cur = norm(nxt)
        for i in range(subsample):
            frame = reader.get()
            if frame is None:
                break
            beta = i / float(subsample)
            rms = (1 - beta) * prev + beta * cur
            rms = np.clip(rms * 2.0 - 0.7, 0, None)
            dir_map = np.clip((rms * 255).astype(int), 0, 255)
            heat = cv2.resize(cmap[dir_map].astype(np.float32), (hw[1], hw[0])) * 255
            alpha = cv2.resize(np.clip(rms, 0, 1).astype(np.float32),
                               (hw[1], hw[0]))[:, :, None] * 0.6
            overlay = alpha * heat + (1 - alpha) * frame
            writer.write_frame(overlay.astype(np.uint8))
    writer.close()


def binauralize_stereo(ambix: np.ndarray) -> np.ndarray:
    """W+/-Y stereo fallback for non-VR playback (myutils.py:285-294)."""
    stereo = np.stack([ambix[:, 0] + ambix[:, 1], ambix[:, 0] - ambix[:, 1]], 1)
    return stereo / (np.abs(stereo).max() / 0.95 + 1e-12)


def gen_360video(audio_fn: str, video_fn: str, output_fn: str,
                 inject_meta: bool = False, overlay_map: bool = False,
                 binauralize: bool = False, no_spatial_audio: bool = False,
                 ambi_order: int = 1, dry_run: bool = False) -> list:
    """Package ambisonic audio + 360 video; returns the command log."""
    log: list = []
    tmp = tempfile.mkdtemp(prefix="sag360_")
    snd_fn = os.path.join(tmp, "audio.wav")
    vid_fn = os.path.join(tmp, "video.mp4")
    mix_fn = os.path.join(tmp, "mixed.mp4")

    _run(["ffmpeg", "-y", "-i", audio_fn, "-vn", "-strict", "-2", snd_fn], dry_run, log)
    _run(["ffmpeg", "-y", "-i", video_fn, "-an", "-vcodec", "copy", vid_fn], dry_run, log)

    if not dry_run:
        if overlay_map:
            ambix, rate = load_wav(snd_fn)
            vid2 = os.path.join(tmp, "video_overlay.mp4")
            overlay_power_map(ambix, rate, vid_fn, vid2)
            log.append(f"[python] overlay_power_map -> {vid2}")
            vid_fn = vid2
        if binauralize:
            ambix, rate = load_wav(snd_fn)
            snd2 = os.path.join(tmp, "stereo.wav")
            save_wav(snd2, binauralize_stereo(ambix), int(rate))
            log.append(f"[python] binauralize_stereo -> {snd2}")
            snd_fn = snd2

    _run(["ffmpeg", "-y", "-i", snd_fn, "-i", vid_fn, "-vcodec", "copy",
          "-strict", "-2", mix_fn], dry_run, log)

    if dry_run:
        log.append(f"[python] inject_spatial_metadata -> {output_fn}"
                   if inject_meta else f"[python] move -> {output_fn}")
        return log

    if inject_meta:
        inject_file(mix_fn, output_fn, spatial_audio=not no_spatial_audio,
                    spherical_video=True, order=ambi_order)
        log.append(f"[python] inject_spatial_metadata -> {output_fn}")
        os.remove(mix_fn)
    else:
        shutil.move(mix_fn, output_fn)
        log.append(f"[python] move -> {output_fn}")
    return log
