"""Per-video multimodal chunk readers over the preprocessed frames layout
(the port's copy of spatialaudiogen_tpu.data.readers, flow readers
included: FlowFrameReader decodes the flow jpgs or the packed flow.npy).

On-disk layout (produced by etl.preprocess / data.synthetic, identical to the
reference's data/frames tree, README.md:81-96):

    {video_id}/
      ambix/000000.wav 000001.wav ...    1-second FOA chunks @ audio_rate
      video/000000.jpg ...               10 fps RGB frames
      flow/000000.jpg ... flow/flow_limits.npy   compressed flow (optional)
      audio_pow.lst                      "t rms" lines every 0.1 s from t=0.5

Behavioral parity with reference feeder.py:50-278: zero padding outside the
recorded range, FOA azimuth rotation on audio + horizontal pixel roll on
frames (same random rotation for all modalities of a chunk), silence
skipping, eval-mode skip_rate subsampling and worker sharding.
"""

from __future__ import annotations

import os

import numpy as np

from spatialaudiogen_tpu_torch.ambisonics.rotation import rotate_ambisonics
from spatialaudiogen_tpu_torch.dsp.geometry import ModelGeometry
from spatialaudiogen_tpu_torch.utils.io_audio import load_wav, wav_info


def _load_jpg(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def audio_window_bounds(start_time: float, rate: float, size: int,
                        num_frames: int) -> tuple[int, int, int]:
    """(start_frame, pad_before, n_read) for a [start, start+size) window.

    Round-to-nearest, not truncation: float times like 1.4 - 0.5 land at
    43199.99999999999 samples; the reference truncates (feeder.py:66) and
    drifts one sample early on such windows — we align exactly. The single
    source of truth for this arithmetic: AudioChunkReader and
    packed.PackedAudioReader both call it (their window-for-window parity
    is pinned in tests/test_packed.py).
    """
    start_frame = int(round(start_time * rate))
    pad_before = max(-start_frame, 0)
    start_frame = max(start_frame, 0)
    pad_after = max(start_frame + size - pad_before - num_frames, 0)
    return start_frame, pad_before, size - pad_before - pad_after


def raw_frame_indices(start_time: float, raw_rate: float, rate: float,
                      size: int, num_frames: int) -> list:
    """Raw on-disk frame numbers for a window, clamped at the last frame.

    Frames are stored at raw_rate; requested rates below it subsample (step
    raw_rate/rate). The reference's FrameReader.get_by_index
    (video.py:172-181) indexed at the requested fps and so read wrong frames
    for fps != raw — a plain bug, fixed here; for rate == raw_rate the
    indices are bit-identical to the reference's. Shared by VideoFrameReader
    and packed.PackedVideoReader.
    """
    ss = max(int(start_time * raw_rate), 0)
    step = raw_rate / rate
    return [min(ss + int(i * step), num_frames - 1) for i in range(size)]


class AudioChunkReader:
    """Reads arbitrary [start_time, start_time+size) windows from 1 s wavs.

    When the native library is available and no resampling is needed, chunk
    files are decoded in C (GIL released) through the per-second cache;
    window assembly (zero-pad, concat, rotation) is vectorized numpy.
    """

    def __init__(self, audio_folder: str, rate: int | None = None, ambi_order: int = 1,
                 use_native: bool = True):
        self.audio_folder = audio_folder
        fns = sorted(fn for fn in os.listdir(audio_folder) if fn.endswith(".wav"))
        assert fns, f"no wav chunks in {audio_folder}"
        self.num_files = len(fns)
        n_frames, n_channels, native_rate = wav_info(os.path.join(audio_folder, fns[0]))
        self.rate = float(native_rate if rate is None else rate)
        self.num_channels = min(n_channels, (ambi_order + 1) ** 2)
        self.ambi_order = ambi_order
        self.duration = self.num_files  # seconds (1 s per file)
        self.num_frames = int(self.duration * self.rate)
        self._cache: dict = {}
        self._native = None
        if use_native and int(self.rate) == int(native_rate):
            from spatialaudiogen_tpu_torch.utils.native import has_symbol, load_native

            lib = load_native()
            if has_symbol(lib, "sag_decode_wav"):
                self._native = lib

    def _load_second(self, i: int) -> np.ndarray:
        if i not in self._cache:
            if len(self._cache) > 16:
                self._cache.clear()
            fn = os.path.join(self.audio_folder, f"{i:06d}.wav")
            if self._native is not None:
                self._cache[i] = self._decode_wav_native(fn)
            else:
                self._cache[i] = load_wav(fn, self.rate, dtype=np.float32)[0]
        return self._cache[i]

    def _decode_wav_native(self, fn: str) -> np.ndarray:
        """Decode one chunk file in C (GIL released during the call).

        Window assembly stays in Python on purpose: consecutive training /
        eval windows overlap by up to `context` seconds, so the per-second
        cache above saves ~10 redundant decodes per second of audio —
        measured faster than assembling whole windows natively without a
        cache (which regressed the feeder 360 -> 250 chunks/s).
        """
        import ctypes

        cap = int(self.rate) * 2  # chunk files hold 1 s; headroom for drift
        out = np.zeros((cap, self.num_channels), np.float32)
        frames = self._native.sag_decode_wav(
            fn.encode(), self.num_channels, cap,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if frames < 0:
            raise IOError(f"native wav decode failed: {fn}")
        return out[:frames]

    def get(self, start_time: float, size: int, rotation: float | None = None) -> np.ndarray:
        start_frame, pad_before, n_read = audio_window_bounds(
            start_time, self.rate, size, self.num_frames)

        out = np.zeros((size, self.num_channels), dtype=np.float32)
        if n_read > 0:
            first = start_frame // int(self.rate)
            last = (start_frame + n_read - 1) // int(self.rate)
            parts = [self._load_second(i)[:, : self.num_channels]
                     for i in range(first, min(last, self.num_files - 1) + 1)]
            chunk = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
            ss = start_frame - first * int(self.rate)
            out[pad_before: pad_before + n_read] = chunk[ss: ss + n_read]

        if rotation is not None:
            assert -np.pi <= rotation < np.pi
            out = rotate_ambisonics(out, rotation).astype(np.float32)
        return out


class VideoFrameReader:
    """Reads jpg frame windows with optional azimuth roll augmentation.

    When the native library is available, a whole window's frames are
    decoded by one libjpeg batch call with the equirect roll fused into the
    row copy (ctypes releases the GIL, so feeder workers scale with host
    cores); `img_prep` is then applied to the stacked (T, H, W, C) array —
    both in-repo preps are elementwise, so per-frame vs batched application
    is identical. Without it, frames fall back to per-frame PIL decode.
    """

    RAW_RATE = 10.0

    def __init__(self, video_folder: str, rate: float | None = None, img_prep=None,
                 use_native: bool = True):
        self.video_folder = video_folder
        self.rate = rate if rate is not None else self.RAW_RATE
        self.img_prep = img_prep if img_prep is not None else (lambda x: x)
        frame_fns = [fn for fn in os.listdir(video_folder) if fn.endswith(".jpg")]
        assert frame_fns, f"no jpg frames in {video_folder}"
        self.num_frames = len(frame_fns)
        self.duration = self.num_frames / self.RAW_RATE
        self._native = None
        if use_native:
            from spatialaudiogen_tpu_torch.utils.native import has_symbol, load_native

            lib = load_native()
            if has_symbol(lib, "sag_jpeg_probe") and \
                    has_symbol(lib, "sag_jpeg_decode_batch"):
                self._native = lib
        first_fn = os.path.join(video_folder, sorted(frame_fns)[0])
        self.raw_shape = None
        if self._native is not None:
            import ctypes

            h = ctypes.c_int()
            w = ctypes.c_int()
            c = ctypes.c_int()
            if self._native.sag_jpeg_probe(first_fn.encode(), ctypes.byref(h),
                                           ctypes.byref(w), ctypes.byref(c)) == 0:
                self.raw_shape = (h.value, w.value, c.value)
            else:
                self._native = None
        if self.raw_shape is None:
            self.raw_shape = _load_jpg(first_fn).shape
            if len(self.raw_shape) == 2:
                self.raw_shape = self.raw_shape + (1,)
        self.frame_shape = self.img_prep(
            np.zeros(self.raw_shape, np.uint8)).shape

    def _decode_window_native(self, frame_nos: list, roll: int) -> np.ndarray | None:
        import ctypes

        paths = b"\0".join(
            os.path.join(self.video_folder, f"{fno:06d}.jpg").encode()
            for fno in frame_nos) + b"\0"
        h, w, c = self.raw_shape
        out = np.empty((len(frame_nos), h, w, c), np.uint8)
        n = self._native.sag_jpeg_decode_batch(
            paths, len(frame_nos), h, w, c, roll,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out if n == len(frame_nos) else None

    def frame_indices(self, start_time: float, size: int) -> list:
        return raw_frame_indices(start_time, self.RAW_RATE, self.rate, size,
                                 self.num_frames)

    def yuv420_supported(self) -> bool:
        """True when frames can ship as raw 4:2:0 planes (native decoder
        present, dims iMCU-aligned, first frame actually 2x2-subsampled)."""
        from spatialaudiogen_tpu_torch.utils.native import has_symbol

        h, w, c = self.raw_shape
        if not (has_symbol(self._native, "sag_jpeg_decode_batch_yuv420")
                and c == 3 and h % 16 == 0 and w % 16 == 0):
            return False
        if not hasattr(self, "_yuv_probe"):
            self._yuv_probe = self.get_yuv420_by_index(0.0, 1) is not None
        return self._yuv_probe

    def get_yuv420_by_index(self, start_time: float, size: int) -> np.ndarray | None:
        """Window of raw I420 planes: (T, h*3/2, w) uint8 — Y (h rows), U
        (h/4 rows), V (h/4 rows); half the bytes of RGB888. None when any
        frame is not a 2x2 YCbCr jpg (caller falls back to get_by_index).
        No roll/img_prep: this is the deploy upload fast path, conversion
        happens on device (deploy/deploy.py fwd_span)."""
        import ctypes

        h, w, _ = self.raw_shape
        frame_nos = self.frame_indices(start_time, size)
        paths = b"\0".join(
            os.path.join(self.video_folder, f"{fno:06d}.jpg").encode()
            for fno in frame_nos) + b"\0"
        out = np.empty((len(frame_nos), h * 3 // 2, w), np.uint8)
        n = self._native.sag_jpeg_decode_batch_yuv420(
            paths, len(frame_nos), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out if n == len(frame_nos) else None

    def get_by_index(self, start_time: float, size: int,
                     rotation: float | None = None) -> np.ndarray:
        # rotate the equirect view horizontally with the audio rotation
        roll = (-int(rotation / (2.0 * np.pi) * self.frame_shape[1])
                if rotation is not None else 0)
        frame_nos = self.frame_indices(start_time, size)
        # the native path rolls raw pixels pre-prep; only valid when
        # img_prep preserves width (both in-repo preps are elementwise)
        native_ok = (self._native is not None and
                     (roll == 0 or self.raw_shape[1] == self.frame_shape[1]))
        if native_ok:
            raw = self._decode_window_native(frame_nos, roll)
            if raw is not None:
                return self.img_prep(raw)
        chunk = [self.img_prep(_load_jpg(
            os.path.join(self.video_folder, f"{fno:06d}.jpg")))
            for fno in frame_nos]
        chunk = np.stack(chunk, 0) if len(chunk) > 1 else chunk[0][np.newaxis]
        if roll:
            chunk = np.roll(chunk, roll, axis=2)
        return chunk


class FlowFrameReader:
    """Decompresses angle/magnitude jpg flow into (dx, dy, mag) float maps.

    Channel semantics per reference feeder.py:147-161: jpg channel 0 holds
    the quantized flow angle, channel 2 the magnitude normalized per-frame by
    flow_limits.npy (T, 2) min/max rows.
    """

    def __init__(self, flow_dir: str, flow_lims_fn: str, rate: float | None = None,
                 flow_prep=None):
        # `flow_prep` is accepted for reference signature parity but, like
        # the reference (feeder.py:141-143 only probes a dummy frame with
        # it; get_by_index never applies it), it is NOT applied to chunks.
        self.reader = VideoFrameReader(flow_dir, rate=rate)
        self.lims = np.load(flow_lims_fn)
        self.rate = self.reader.rate
        self.duration = self.reader.duration
        self.frame_shape = self.reader.frame_shape

    def get_by_index(self, start_time: float, size: int,
                     rotation: float | None = None) -> np.ndarray:
        # a rotation rolls the flow pixels along W as it rolls video frames
        # and leaves the vectors' angle as it is (the reference's behaviour)
        chunk = self.reader.get_by_index(start_time, size, rotation).astype(np.float32)
        return decode_flow(chunk, self.lims, self.reader.frame_indices(start_time, size))


def decode_flow(chunk: np.ndarray, lims: np.ndarray, frame_nos) -> np.ndarray:
    """(T, H, W, 3) float32 flow pixels -> (dx, dy, mag) float32 maps.

    The per-frame limits follow the same (clamped, raw-rate) frame indices
    as the frames, clamped into lims: the reference sliced lims[ss:ss+t]
    unclamped and crashed on windows overrunning the frame count (plain bug,
    fixed; identical for in-range windows)."""
    idx = np.minimum(frame_nos, len(lims) - 1)
    m_min = lims[idx, 0].reshape((-1, 1, 1))
    m_max = lims[idx, 1].reshape((-1, 1, 1))
    mag = chunk[:, :, :, 2] * (m_max - m_min) / 255.0 + m_min
    ang = chunk[:, :, :, 0] * (2 * np.pi) / 255.0
    out = np.empty_like(chunk)
    out[:, :, :, 0] = mag * np.cos(ang)
    out[:, :, :, 1] = mag * np.sin(ang)
    out[:, :, :, 2] = mag
    return out


def img_prep_default(x: np.ndarray) -> np.ndarray:
    """Training image preprocessing (myutils.py:88-89): x/255 - 0.5."""
    return x.astype(np.float32) / 255.0 - 0.5


def img_prep_u8(x: np.ndarray) -> np.ndarray:
    """Identity prep: frames stay uint8 through the feeder and the train
    step normalizes them on the device (the same x/255 - 0.5 in f32) — 4x
    less host->device traffic and no host float conversion. The Trainer's
    transport."""
    return x


class SampleReader:
    """Synchronized multimodal chunk extraction for one video
    (parity with reference feeder.py:164-278)."""

    def __init__(self, folder: str,
                 ambi_order: int = 1,
                 audio_rate: int = 48000,
                 video_rate: int = 10,
                 context: float = 1.0,
                 duration: float = 0.1,
                 return_video: bool = True,
                 img_prep=None,
                 return_flow: bool = False,
                 flow_prep=None,
                 skip_silence_thr: float | None = None,
                 shuffle: bool = True,
                 start_time: float = 0.5,
                 sample_duration: float | None = None,
                 skip_rate: int | None = None,
                 random_rotations: bool = True,
                 num_workers: int = 1,
                 worker_id: int = 0,
                 rng: np.random.RandomState | None = None,
                 audio_reader: AudioChunkReader | None = None,
                 video_reader: VideoFrameReader | None = None,
                 flow_reader: FlowFrameReader | None = None,
                 use_packed: bool | None = None):
        a2v = float(audio_rate) / video_rate
        snd_dur = duration * audio_rate
        vid_dur = duration * video_rate
        snd_ctx = context * audio_rate
        assert a2v == int(a2v)
        assert float(snd_dur) == int(snd_dur)
        assert float(vid_dur) == int(vid_dur)
        assert float(snd_ctx) == int(snd_ctx)

        self.video_id = os.path.split(folder)[-1]
        self.folder = folder
        self.rng = rng if rng is not None else np.random.RandomState()

        # sub-readers may be shared across visits (their decode caches stay
        # warm; readers are stateless w.r.t. chunk iteration). When the video
        # has an ahead-of-time pack (data/packed.py, `sag-pack`) the packed
        # memmap readers serve windows decode-free; use_packed=None
        # auto-detects, False forces the decode path (parity oracle).
        from spatialaudiogen_tpu_torch.data import packed as _packed

        if use_packed is None:
            # packs never resample on read; a rate-mismatched pack falls
            # back to the wav decode path rather than asserting
            use_packed = (_packed.is_packed(folder)
                          and _packed.pack_rate(folder) == int(audio_rate))
        elif use_packed:
            assert _packed.is_packed(folder), f"no pack in {folder}"
        self.audio_reader = audio_reader
        self.video_reader = video_reader
        self.flow_reader = flow_reader
        if self.audio_reader is None:
            self.audio_reader = (
                _packed.PackedAudioReader(folder, audio_rate, ambi_order)
                if use_packed else
                AudioChunkReader(os.path.join(folder, "ambix"), audio_rate,
                                 ambi_order))
        if return_video and self.video_reader is None:
            self.video_reader = (
                _packed.PackedVideoReader(folder, video_rate, img_prep)
                if use_packed else
                VideoFrameReader(os.path.join(folder, "video"), video_rate,
                                 img_prep))
        if return_flow and self.flow_reader is None:
            flow_dir = os.path.join(folder, "flow")
            self.flow_reader = (
                _packed.PackedFlowReader(folder, video_rate, flow_prep)
                if use_packed else
                FlowFrameReader(flow_dir,
                                os.path.join(flow_dir, "flow_limits.npy"),
                                video_rate, flow_prep))
        self.duration = duration
        self.context = context
        self.audio_rate = audio_rate
        self.video_rate = video_rate
        # window sizes come from the single source of truth (dsp.geometry),
        # not re-derived index math (CLAUDE.md convention)
        _g = ModelGeometry(ambi_order, audio_rate, video_rate, context, duration)
        self.audio_size = _g.snd_size
        self.video_size = _g.vid_dur
        self.random_rotations = random_rotations

        # candidate chunk start times from the precomputed power index
        pow_fn = os.path.join(folder, "audio_pow.lst")
        rows = [line.strip().split() for line in open(pow_fn)]
        chunks_t = [float(r[0]) for r in rows]
        chunks_pow = [float(r[1]) for r in rows]
        if skip_rate is not None:
            chunks_t = chunks_t[::skip_rate]
            chunks_pow = chunks_pow[::skip_rate]
        if skip_silence_thr is not None:
            chunks_t = [t for t, p in zip(chunks_t, chunks_pow) if p > skip_silence_thr]
        if start_time > 0.5:
            chunks_t = [t for t in chunks_t if t >= start_time]
        if sample_duration is not None:
            chunks_t = [t for t in chunks_t if t < start_time + sample_duration]
        if num_workers > 1:
            lims = np.linspace(0, len(chunks_t), num_workers + 1).astype(int)
            chunks_t = chunks_t[lims[worker_id]: lims[worker_id + 1]]
        if shuffle:
            perm = self.rng.permutation(len(chunks_t))
            chunks_t = [chunks_t[i] for i in perm]
        self.chunks_t = chunks_t
        self.head = -1

    def get(self):
        self.head += 1
        if self.head >= len(self.chunks_t):
            return None
        cur_t = self.chunks_t[self.head]
        rotation = (self.rng.rand() * 2 * np.pi - np.pi) if self.random_rotations else None
        chunk = {"id": f"{self.video_id} {cur_t}"}
        audio_ss = cur_t - self.context / 2
        chunk["ambix"] = self.audio_reader.get(audio_ss, self.audio_size,
                                               rotation).astype(np.float32)
        if self.video_reader is not None:
            video = self.video_reader.get_by_index(cur_t, self.video_size,
                                                   rotation)
            # u8 stays u8 (img_prep_u8 device-normalization transport);
            # everything else is coerced f32 as the reference feeder does
            chunk["video"] = (video if video.dtype == np.uint8
                              else video.astype(np.float32))
        if self.flow_reader is not None:
            chunk["flow"] = self.flow_reader.get_by_index(
                cur_t, self.video_size, rotation).astype(np.float32)
        return chunk

    def loop_chunks(self, n: float = np.inf):
        k = 0
        while k < n:
            k += 1
            chunk = self.get()
            if chunk is None:
                break
            yield chunk
