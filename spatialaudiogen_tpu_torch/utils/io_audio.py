"""WAV audio I/O without external native deps (the port's copy of the parts
of spatialaudiogen_tpu.utils.io_audio it calls).

`load_wav` returns float (frames, channels) in [-1, 1] and resamples if a
target rate is given; `save_wav` writes 16-bit PCM or float32. Reading
handles PCM 8/16/24/32 and IEEE float 32/64 RIFF files directly.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _read_riff_chunks(f):
    header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    chunks = {}
    while True:
        head = f.read(8)
        if len(head) < 8:
            break
        cid, size = head[:4], struct.unpack("<I", head[4:])[0]
        pos = f.tell()
        if cid == b"data":
            chunks[b"data"] = (pos, size)
            f.seek(size + (size & 1), os.SEEK_CUR)
        else:
            chunks[cid] = (pos, size)
            f.seek(size + (size & 1), os.SEEK_CUR)
    return chunks


def read_wav_raw(path: str, dtype=np.float32):
    """Decode a RIFF/WAVE file -> (float array (frames, channels), rate).

    dtype defaults to float32 — the feeder's consumption format; pass
    float64 for full-precision DSP work.
    """
    with open(path, "rb") as f:
        chunks = _read_riff_chunks(f)
        if b"fmt " not in chunks or b"data" not in chunks:
            raise ValueError(f"Malformed wav file: {path}")
        pos, size = chunks[b"fmt "]
        f.seek(pos)
        fmt = f.read(size)
        (audio_format, n_channels, rate, _, block_align, bits) = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        pos, size = chunks[b"data"]
        f.seek(pos)
        raw = f.read(size)

    n_frames = len(raw) // block_align
    raw = raw[: n_frames * block_align]
    if audio_format == 1:  # PCM
        if bits == 8:
            data = np.frombuffer(raw, dtype=np.uint8).astype(dtype)
            data = (data - 128.0) / 128.0
        elif bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(dtype) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            data = val.astype(dtype) / float(1 << 23)
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(dtype) / float(1 << 31)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        src_dtype = "<f4" if bits == 32 else "<f8"
        data = np.frombuffer(raw, dtype=src_dtype).astype(dtype)
    else:
        raise ValueError(f"Unsupported wav format code: {audio_format}")

    return data.reshape(n_frames, n_channels), rate


def load_wav(path: str, rate: int | None = None, dtype=np.float64):
    """Read a wav; optionally resample to `rate`. Returns (data, rate)."""
    data, in_rate = read_wav_raw(path, dtype=dtype)
    if rate is not None and int(rate) != int(in_rate):
        from spatialaudiogen_tpu_torch.utils.resample import resample

        data = resample(data, in_rate, rate)
        in_rate = int(rate)
    return data, float(in_rate)


def pcm16_exact(data: np.ndarray) -> np.ndarray | None:
    """int16 image of `data` if it sits exactly on the PCM16 grid, else None.

    PCM16 decode here is int16/32768 (read_wav_raw), so float audio that
    originated from PCM16 round-trips losslessly through this cast. Shared
    by the deploy int16 span transport and the sag-pack audio writer so the
    two sites can never disagree on what "lossless" means.
    """
    i16 = np.clip(np.round(data * 32768.0), -32768, 32767)
    if np.array_equal(i16.astype(data.dtype) / 32768.0, data):
        return i16.astype(np.int16)
    return None


def save_wav(path: str, data: np.ndarray, rate: int, subtype: str = "pcm16"):
    """Write (frames, channels) float data in [-1, 1] as PCM16/float32 wav."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_frames, n_channels = data.shape
    if subtype == "pcm16":
        fmt_code, bits = 1, 16
        payload = np.clip(np.round(data * 32767.0), -32768, 32767).astype("<i2").tobytes()
    elif subtype == "float32":
        fmt_code, bits = 3, 32
        payload = data.astype("<f4").tobytes()
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")
    block_align = n_channels * bits // 8
    byte_rate = int(rate) * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, n_channels, int(rate), byte_rate,
                            block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def wav_info(path: str):
    """(n_frames, n_channels, rate) without decoding samples."""
    with open(path, "rb") as f:
        chunks = _read_riff_chunks(f)
        pos, size = chunks[b"fmt "]
        f.seek(pos)
        fmt = f.read(size)
        (_, n_channels, rate, _, block_align, _) = struct.unpack("<HHIIHH", fmt[:16])
        _, data_size = chunks[b"data"]
    return data_size // block_align, n_channels, rate

