"""Synthetic dataset generator in the reference on-disk layout (the port's
copy of spatialaudiogen_tpu.data.synthetic; Pillow is imported only when
a jpg is written).

Builds tiny but physically meaningful datasets for tests, smoke training and
benchmarks without any real video data: a moving broadband source is encoded
to FOA with the ambisonics encoder (so the audio is exactly spatial), frames
render a bright blob at the source's equirectangular position (so the visual
stream genuinely carries localization information), and audio_pow.lst matches
the preprocessing contract (rms of W every 0.1 s from t=0.5,
scraping/preprocess.py:146-153).
"""

from __future__ import annotations

import os

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.encoder import AmbiEncoder
from spatialaudiogen_tpu_torch.ambisonics.format import AmbiFormat
from spatialaudiogen_tpu_torch.ambisonics.position import MovingSource, Position
from spatialaudiogen_tpu_torch.utils.io_audio import save_wav


def _save_jpg(path: str, array: np.ndarray):
    from PIL import Image

    Image.fromarray(array.astype(np.uint8)).save(path, quality=90)


def _render_frames(phi_per_frame, nu_per_frame, n_frames, hw):
    """Equirect frames with a bright gaussian blob at the source direction."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w]
    frames = np.zeros((n_frames, h, w, 3), np.uint8)
    for i in range(n_frames):
        # equirect: x ~ azimuth (+phi left of center), y ~ elevation
        cx = (0.5 - phi_per_frame[i] / (2 * np.pi)) % 1.0 * w
        cy = (0.5 - nu_per_frame[i] / np.pi) * h
        dx = np.minimum(np.abs(xs - cx), w - np.abs(xs - cx))
        blob = np.exp(-((dx ** 2 + (ys - cy) ** 2) / (2 * (0.05 * w) ** 2)))
        img = np.stack([blob * 255, blob * 180, np.full_like(blob, 20)], axis=-1)
        frames[i] = np.clip(img, 0, 255)
    return frames


def make_video(root: str, yid: str, duration: float = 4.0, audio_rate: int = 48000,
               video_rate: int = 10, frame_hw=(224, 448), with_flow: bool = False,
               seed: int = 0, ambi_order: int = 1):
    rng = np.random.RandomState(seed)
    folder = os.path.join(root, yid)
    os.makedirs(os.path.join(folder, "ambix"), exist_ok=True)
    os.makedirs(os.path.join(folder, "video"), exist_ok=True)

    n_samples = int(duration * audio_rate)
    t = np.arange(n_samples) / audio_rate
    sig = (0.4 * np.sin(2 * np.pi * (300 + 80 * seed) * t)
           + 0.2 * rng.randn(n_samples)).astype(np.float64)

    phi0, phi1 = rng.uniform(-np.pi, np.pi, 2)
    nu0, nu1 = rng.uniform(-0.5, 0.5, 2)
    keypoints = [Position(phi0, nu0, 1.0, "polar"), Position(phi1, nu1, 1.0, "polar")]
    src = MovingSource(sig, keypoints, audio_rate)
    foa = AmbiEncoder(AmbiFormat(order=ambi_order,
                                 sample_rate=audio_rate)).encode_moving(src).data
    # Scale so the W channel clears the training silence gate (rms 0.2,
    # feeder thresholds at pipeline.Feeder) without clipping PCM16.
    w_rms = np.sqrt((foa[:, 0] ** 2).mean())
    scale = min(0.3 / (w_rms + 1e-9), 0.95 / (np.abs(foa).max() + 1e-9))
    foa *= scale
    assert np.sqrt((foa[:, 0] ** 2).mean()) > 0.22, "synthetic W too quiet"

    n_secs = int(duration)
    for i in range(n_secs):
        save_wav(os.path.join(folder, "ambix", f"{i:06d}.wav"),
                 foa[i * audio_rate: (i + 1) * audio_rate], audio_rate)

    # frames track the source trajectory
    n_frames = int(duration * video_rate)
    traj = src.trajectory()
    idx = np.linspace(0, traj.shape[0] - 1, n_frames).astype(int)
    frames = _render_frames(traj[idx, 0], traj[idx, 1], n_frames, frame_hw)
    for i in range(n_frames):
        _save_jpg(os.path.join(folder, "video", f"{i:06d}.jpg"), frames[i])

    if with_flow:
        flow_dir = os.path.join(folder, "flow")
        os.makedirs(flow_dir, exist_ok=True)
        lims = np.zeros((n_frames, 2), np.float32)
        for i in range(n_frames):
            ang = rng.randint(0, 255, frame_hw, np.uint8)
            mag = rng.randint(0, 255, frame_hw, np.uint8)
            _save_jpg(os.path.join(flow_dir, f"{i:06d}.jpg"),
                      np.stack([ang, np.zeros(frame_hw, np.uint8), mag], -1))
            lims[i] = (0.0, rng.uniform(1.0, 3.0))
        np.save(os.path.join(flow_dir, "flow_limits.npy"), lims)

    # audio power index: rms of W over each 0.1 s window from t=0.5
    with open(os.path.join(folder, "audio_pow.lst"), "w") as f:
        for i in range((n_secs - 1) * 10):
            tt = i / 10.0 + 0.5
            ss = int(tt * audio_rate)
            w = foa[ss: ss + audio_rate // 10, 0]
            f.write(f"{tt} {np.sqrt((w ** 2).mean())}\n")
    return folder


def make_synthetic_dataset(root: str, n_videos: int = 2, duration: float = 4.0,
                           audio_rate: int = 48000, video_rate: int = 10,
                           frame_hw=(224, 448), with_flow: bool = False,
                           seed: int = 0, ambi_order: int = 1):
    os.makedirs(root, exist_ok=True)
    ids = []
    for v in range(n_videos):
        yid = f"synth{v:03d}"
        make_video(root, yid, duration, audio_rate, video_rate, frame_hw,
                   with_flow, seed=seed + v, ambi_order=ambi_order)
        ids.append(yid)
    return ids
