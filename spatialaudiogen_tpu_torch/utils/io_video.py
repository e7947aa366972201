"""Video I/O: file readers/writers (OpenCV-backed) and jpg frame dirs (the
port's copy of spatialaudiogen_tpu.utils.io_video).

Capability parity with reference pyutils/iolib/video.py (BasicVideoReader /
FrameReader / VideoReader / VideoWriter / getFFprobeMeta) without requiring
an ffmpeg binary for the common paths: OpenCV ships its own demuxers/codecs.
ffprobe metadata remains a gated subprocess helper for the ETL tools.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np


def get_ffprobe_meta(filename: str) -> dict:
    """Stream metadata via ffprobe (requires the binary on PATH)."""
    if shutil.which("ffprobe") is None:
        raise RuntimeError("ffprobe not found on PATH; install ffmpeg tools")
    cmd = ["ffprobe", "-v", "quiet", "-print_format", "json",
           "-show_format", "-show_streams", filename]
    out = subprocess.run(cmd, check=True, capture_output=True).stdout
    meta = json.loads(out)
    by_type = {}
    for stream in meta.get("streams", []):
        by_type[stream.get("codec_type", "?")] = stream
    by_type["format"] = meta.get("format", {})
    return by_type


class BasicVideoReader:
    """Sequential frame reader with fps resampling (video.py:36-145 parity)."""

    def __init__(self, video_fn: str, rate: float | None = None,
                 pad_start: int = 0, seek: float = 0):
        import cv2

        self._cap = cv2.VideoCapture(video_fn)
        assert self._cap.isOpened(), f"cannot open video: {video_fn}"
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.raw_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.duration = self.raw_frames / self.fps
        self.rate = rate if rate is not None else self.fps
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.frame_shape = (h, w, 3)
        self._next_src = 0          # next raw frame index to decode
        self._out_index = -pad_start
        self._last = np.zeros(self.frame_shape, np.uint8)
        if seek > 0:
            import cv2 as _cv2

            self._cap.set(_cv2.CAP_PROP_POS_FRAMES, int(seek * self.fps))
            self._next_src = int(seek * self.fps)

    def get(self):
        import cv2

        self._out_index += 1
        if self._out_index < 0:
            return np.zeros(self.frame_shape, np.uint8)
        target_src = int(self._out_index * self.fps / self.rate)
        while self._next_src <= target_src:
            ok, frame = self._cap.read()
            if not ok:
                return None
            self._last = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            self._next_src += 1
        return self._last

    def loop_frames(self):
        while True:
            frame = self.get()
            if frame is None:
                break
            yield frame


class FrameDirReader:
    """Reader over a directory of {:06d}.jpg frames (video.py:148-205)."""

    def __init__(self, frame_dir: str, raw_rate: float = 10.0, rate: float | None = None):
        self.frame_dir = frame_dir
        self.fns = sorted(fn for fn in os.listdir(frame_dir) if fn.endswith(".jpg"))
        assert self.fns
        self.raw_rate = raw_rate
        self.rate = rate if rate is not None else raw_rate
        self.num_frames = len(self.fns)
        self.duration = self.num_frames / raw_rate
        self._idx = -1

    def _load(self, i: int) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.frame_dir, self.fns[i])) as img:
            return np.asarray(img)

    def get(self):
        self._idx += 1
        src = int(self._idx * self.raw_rate / self.rate)
        if src >= self.num_frames:
            return None
        return self._load(src)


class VideoWriter:
    """mp4 writer via OpenCV (video.py:301-335 parity, no ffmpeg binary)."""

    def __init__(self, output_fn: str, fps: float, frame_hw=None):
        self.output_fn = output_fn
        self.fps = fps
        self.frame_hw = frame_hw
        self._writer = None

    def _ensure(self, frame):
        if self._writer is None:
            import cv2

            h, w = frame.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.output_fn, fourcc, self.fps, (w, h))
            assert self._writer.isOpened(), f"cannot open writer: {self.output_fn}"

    def write_frame(self, frame: np.ndarray):
        import cv2

        self._ensure(frame)
        self._writer.write(cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_RGB2BGR))

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __del__(self):
        self.close()
