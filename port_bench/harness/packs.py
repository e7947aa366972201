"""Datasets written from a seed in the packed layout the program reads
(`{clip}/packed/{meta.json, ambix.npy, video.npy, flow.npy,
flow_lims.npy}` and `{clip}/audio_pow.lst`), in a few bulk numpy calls.

Audio: first-order ambisonics (ACN W, Y, Z, X) of one source moving over
the horizon, W a tone in noise at an RMS of about 0.29 so every 0.1 s
window passes the train feeder's 0.2 silence gate, PCM16. Frames: uint8
RGB noise at 10 fps. Flow: angle and magnitude bytes with per-frame
magnitude limits, as the flow jpgs hold them."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

RATE = 48000
FPS = 10


def clip_audio(rng: np.random.Generator, seconds: int) -> np.ndarray:
    n = seconds * RATE
    t = np.arange(n) / RATE
    tone = np.sin(2 * np.pi * rng.uniform(200.0, 800.0) * t)
    w = 0.3 * tone + 0.3 * rng.standard_normal(n)
    az = np.cumsum(rng.standard_normal(n)) * (2 * np.pi / n ** 0.5) + rng.uniform(-np.pi, np.pi)
    foa = np.stack([w, w * np.sin(az), 0.2 * w, w * np.cos(az)], 1)
    foa += 0.02 * rng.standard_normal(foa.shape)
    return np.clip(np.round(foa * 32767 * 0.8), -32768, 32767).astype(np.int16)


def audio_pow_rows(audio: np.ndarray) -> str:
    """RMS of W over each 0.1 s window from 0.5 s: the chunk index the
    feeder draws training windows from."""
    rows = []
    for i in range((audio.shape[0] // RATE - 1) * FPS):
        tt = i / 10.0 + 0.5
        ss = int(tt * RATE)
        seg = audio[ss: ss + RATE // FPS, 0] / 32768.0
        rows.append(f"{tt} {np.sqrt((seg ** 2).mean())}\n")
    return "".join(rows)


def write_clip(folder: Path, rng: np.random.Generator, seconds: int, frame_hw,
               flow: bool) -> None:
    audio = clip_audio(rng, seconds)
    h, w = frame_hw
    n_frames = seconds * FPS
    pack = folder / "packed"
    pack.mkdir(parents=True)
    np.save(pack / "ambix.npy", audio)
    np.save(pack / "video.npy", rng.integers(0, 256, (n_frames, h, w, 3), dtype=np.uint8))
    meta = {"version": 1, "rate": RATE, "num_channels": 4, "num_files": seconds,
            "audio_dtype": "int16", "video_frames": n_frames, "frame_shape": [h, w, 3]}
    if flow:
        pixels = rng.integers(0, 256, (n_frames, h, w, 3), dtype=np.uint8)
        pixels[..., 1] = 0
        lims = np.stack([np.zeros(n_frames), rng.uniform(1.0, 3.0, n_frames)], 1)
        np.save(pack / "flow.npy", pixels)
        np.save(pack / "flow_lims.npy", lims.astype(np.float32))
        meta.update(flow_frames=n_frames, flow_shape=[h, w, 3])
    (pack / "meta.json").write_text(json.dumps(meta))
    (folder / "audio_pow.lst").write_text(audio_pow_rows(audio))


def write_db(db: Path, seed: int, clips: int, seconds: int, frame_hw, flow: bool) -> list:
    """`clips` clips of `seconds` under db/clip{i}; -> their folders."""
    rng = np.random.default_rng(int(seed))
    folders = [db / f"clip{i}" for i in range(clips)]
    for folder in folders:
        write_clip(folder, rng, seconds, frame_hw, flow)
    return folders
