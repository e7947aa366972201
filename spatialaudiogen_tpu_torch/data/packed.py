"""Readers of ahead-of-time packed media (the port's copy of the reader
side of spatialaudiogen_tpu.data.packed; packs are written by the JAX
package's `sag-pack`, or by any writer of this layout).

Layout (per video, next to the source dirs):

    {video_id}/packed/
      meta.json        {"rate", "num_channels", "num_files", "audio_dtype",
                        "video_frames", "frame_shape", ...}
      ambix.npy        (T_samples, C) int16 when the source wavs are
                       PCM16-exact (lossless: decode is int16/32768), else
                       float32
      video.npy        (N_frames, H, W, 3) uint8 decoded rgb frames
      flow.npy         (N_frames, H, W, 3) uint8 + flow_lims.npy (N, 2):
                       the compressed flow jpgs' decoded pixels and their
                       per-frame magnitude limits (meta "flow_frames",
                       "flow_shape")

The packed readers reproduce readers.AudioChunkReader / VideoFrameReader /
FlowFrameReader semantics exactly (same window rounding, zero padding, rotation/roll
augmentation, frame-index clamping). SampleReader auto-detects a pack.
"""

from __future__ import annotations

import json
import os

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.rotation import rotate_ambisonics

META_FN = "meta.json"
PACK_DIR = "packed"


def pack_dir(folder: str) -> str:
    return os.path.join(folder, PACK_DIR)


def is_packed(folder: str) -> bool:
    return os.path.exists(os.path.join(folder, PACK_DIR, META_FN))


def pack_rate(folder: str) -> int:
    """Audio rate a pack was written at (packs never resample on read)."""
    with open(os.path.join(folder, PACK_DIR, META_FN)) as f:
        return json.load(f)["rate"]


class PackedAudioReader:
    """AudioChunkReader semantics over the packed (T, C) array."""

    def __init__(self, folder: str, rate: int | None = None, ambi_order: int = 1):
        out_dir = pack_dir(folder)
        with open(os.path.join(out_dir, META_FN)) as f:
            meta = json.load(f)
        self._data = np.load(os.path.join(out_dir, "ambix.npy"), mmap_mode="r")
        native_rate = meta["rate"]
        assert rate is None or int(rate) == int(native_rate), \
            f"packed audio is {native_rate} Hz; resampling needs the wav path"
        self.rate = float(native_rate)
        self.num_channels = min(meta["num_channels"], (ambi_order + 1) ** 2)
        self.ambi_order = ambi_order
        self.num_files = meta["num_files"]
        self.duration = self.num_files  # seconds (parity: 1 s per source file)
        self.num_frames = int(self.duration * self.rate)

    def get(self, start_time: float, size: int,
            rotation: float | None = None) -> np.ndarray:
        from spatialaudiogen_tpu_torch.data.readers import audio_window_bounds

        start_frame, pad_before, n_read = audio_window_bounds(
            start_time, self.rate, size, self.num_frames)

        out = np.zeros((size, self.num_channels), dtype=np.float32)
        if n_read > 0:
            chunk = self._data[start_frame: start_frame + n_read,
                               : self.num_channels]
            if chunk.dtype == np.int16:
                chunk = chunk.astype(np.float32) / 32768.0
            out[pad_before: pad_before + n_read] = chunk
        if rotation is not None:
            assert -np.pi <= rotation < np.pi
            out = rotate_ambisonics(out, rotation).astype(np.float32)
        return out


class PackedVideoReader:
    """VideoFrameReader semantics over the packed (N, H, W, C) array."""

    RAW_RATE = 10.0

    def __init__(self, folder: str, rate: float | None = None, img_prep=None,
                 key: str = "video"):
        out_dir = pack_dir(folder)
        with open(os.path.join(out_dir, META_FN)) as f:
            meta = json.load(f)
        self._frames = np.load(os.path.join(out_dir, f"{key}.npy"),
                               mmap_mode="r")
        self.rate = rate if rate is not None else self.RAW_RATE
        self.img_prep = img_prep if img_prep is not None else (lambda x: x)
        self.num_frames = meta[f"{key}_frames"]
        self.duration = self.num_frames / self.RAW_RATE
        self.raw_shape = tuple(meta["frame_shape" if key == "video"
                                    else "flow_shape"])
        self.frame_shape = self.img_prep(
            np.zeros(self.raw_shape, np.uint8)).shape

    def frame_indices(self, start_time: float, size: int) -> list:
        from spatialaudiogen_tpu_torch.data.readers import raw_frame_indices

        return raw_frame_indices(start_time, self.RAW_RATE, self.rate, size,
                                 self.num_frames)

    def get_by_index(self, start_time: float, size: int,
                     rotation: float | None = None) -> np.ndarray:
        roll = (-int(rotation / (2.0 * np.pi) * self.frame_shape[1])
                if rotation is not None else 0)
        idx = self.frame_indices(start_time, size)
        # contiguous windows (the common case) slice; ragged ones gather
        if idx == list(range(idx[0], idx[0] + size)):
            chunk = np.asarray(self._frames[idx[0]: idx[0] + size])
        else:
            chunk = np.asarray(self._frames[idx])
        if roll:
            chunk = np.roll(chunk, roll, axis=2)
        return self.img_prep(chunk)


class PackedFlowReader:
    """FlowFrameReader semantics over packed flow pixels + limits."""

    def __init__(self, folder: str, rate: float | None = None, flow_prep=None):
        # flow_prep: signature parity only; never applied (readers.py note)
        self.reader = PackedVideoReader(folder, rate=rate, key="flow")
        self.lims = np.load(os.path.join(pack_dir(folder), "flow_lims.npy"))
        self.rate = self.reader.rate
        self.duration = self.reader.duration
        self.frame_shape = self.reader.frame_shape

    def get_by_index(self, start_time: float, size: int,
                     rotation: float | None = None) -> np.ndarray:
        from spatialaudiogen_tpu_torch.data.readers import decode_flow

        chunk = self.reader.get_by_index(start_time, size, rotation).astype(np.float32)
        return decode_flow(chunk, self.lims, self.reader.frame_indices(start_time, size))
