"""Ahead-of-time packed media: decode-free feeding for the training hot loop
(the port's copy of spatialaudiogen_tpu.data.packed: the writer behind
`sag-torch-pack` and the readers).

`sag-torch-pack` decodes each video of a preprocessed frames dataset once
into flat memory-mappable arrays, and the packed readers serve training
windows as numpy slices (no decode). The pack is additive: the `ambix/`,
`video/` and `flow/` dirs keep working and may be deleted afterwards
(only `audio_pow.lst` must stay: chunk candidacy still comes from it).
The files it writes are byte for byte those of the JAX package's
`sag-pack`, and each package reads the other's packs.

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


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _pack_audio(folder: str, out_dir: str, meta: dict) -> None:
    """Stream the clip's audio into a memmapped .npy, one second at a time
    (a 10-minute 4-ch clip never holds more than ~400 KB in RAM, in each of
    pack_all's workers)."""
    from spatialaudiogen_tpu_torch.data.readers import AudioChunkReader
    from spatialaudiogen_tpu_torch.utils.io_audio import pcm16_exact

    # ambi_order=10 caps channels at 121: the pack stores EVERY recorded
    # channel; readers re-apply their own ambi_order cut at read time
    reader = AudioChunkReader(os.path.join(folder, "ambix"), rate=None,
                              ambi_order=10)
    rate = int(reader.rate)
    nch = int(reader.num_channels)

    def seconds():
        for i in range(reader.num_files):
            yield i, reader._load_second(i)[:, :nch].astype(np.float32)

    # pass 1: sizes + the int16-losslessness decision (whole clip)
    counts, all_exact = [], True
    for i, sec in seconds():
        if i < reader.num_files - 1:
            # AudioChunkReader.get indexes the concatenation at i*rate;
            # packing is only layout-equivalent when every non-final chunk
            # is exactly 1 s
            assert sec.shape[0] == rate, \
                f"{folder}: chunk {i} holds {sec.shape[0]} frames, expected {rate}"
        counts.append(sec.shape[0])
        all_exact = all_exact and pcm16_exact(sec) is not None
    dtype = np.int16 if all_exact else np.float32  # lossless when PCM16-sourced
    out = np.lib.format.open_memmap(
        os.path.join(out_dir, "ambix.npy"), mode="w+", dtype=dtype,
        shape=(int(sum(counts)), nch))
    # pass 2: write (the reader's 16-second decode cache makes the second
    # decode of short clips free; long clips re-decode natively, cheap)
    pos = 0
    for i, sec in seconds():
        out[pos: pos + sec.shape[0]] = pcm16_exact(sec) if all_exact else sec
        pos += sec.shape[0]
    out.flush()
    del out
    meta["rate"] = rate
    meta["num_channels"] = nch
    meta["num_files"] = int(reader.num_files)
    meta["audio_dtype"] = str(np.dtype(dtype))


def _pack_frames(video_dir: str, out_fn: str, batch: int = 64):
    """Decode every jpg of a frame dir into one uint8 .npy (streamed through
    a memmap so a long video never materializes in RAM)."""
    from spatialaudiogen_tpu_torch.data.readers import VideoFrameReader

    reader = VideoFrameReader(video_dir, rate=VideoFrameReader.RAW_RATE,
                              img_prep=lambda x: x)
    n = reader.num_frames
    shape = (n,) + tuple(reader.raw_shape)
    out = np.lib.format.open_memmap(out_fn, mode="w+", dtype=np.uint8,
                                    shape=shape)
    for s in range(0, n, batch):
        m = min(batch, n - s)
        # rate == RAW_RATE => frame_indices(s/RAW_RATE, m) is s..s+m-1
        out[s: s + m] = reader.get_by_index(s / reader.RAW_RATE, m)
    out.flush()
    del out
    return n, reader.raw_shape


def pack_video(folder: str, force: bool = False) -> str:
    """Pack one video's media; idempotent unless force. Returns the pack dir.

    Writes meta.json last, so an interrupted pack is retried (is_packed keys
    on the meta file) rather than half-read.
    """
    out_dir = pack_dir(folder)
    if is_packed(folder) and not force:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    meta: dict = {"version": 1}
    _pack_audio(folder, out_dir, meta)

    video_dir = os.path.join(folder, "video")
    if os.path.isdir(video_dir):
        n, shape = _pack_frames(video_dir, os.path.join(out_dir, "video.npy"))
        meta["video_frames"] = int(n)
        meta["frame_shape"] = [int(x) for x in shape]

    flow_dir = os.path.join(folder, "flow")
    if os.path.isdir(flow_dir):
        n, shape = _pack_frames(flow_dir, os.path.join(out_dir, "flow.npy"))
        meta["flow_frames"] = int(n)
        meta["flow_shape"] = [int(x) for x in shape]
        lims = np.load(os.path.join(flow_dir, "flow_limits.npy"))
        np.save(os.path.join(out_dir, "flow_lims.npy"), lims)

    with open(os.path.join(out_dir, META_FN), "w") as f:
        json.dump(meta, f)
    return out_dir


# ---------------------------------------------------------------------------
# readers (drop-in duals of readers.{AudioChunkReader,VideoFrameReader,
# FlowFrameReader}; constructed by SampleReader when is_packed())
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# CLI: sag-torch-pack
# ---------------------------------------------------------------------------

def pack_all(db_dir: str, subset_fn: str | None = None, n_workers: int = 4,
             force: bool = False) -> list:
    """Pack every video dir of a dataset (idempotent). More than one worker
    packs in a pool of spawned processes: a forked worker would inherit
    the caller's threads (torch's, a CUDA context's) mid-state."""
    from spatialaudiogen_tpu_torch.data.providers import FilenameProvider

    provider = FilenameProvider(db_dir, subset_fn, num_epochs=1)
    folders = [os.path.join(db_dir, yid) for yid in provider.loop_samples()]
    if n_workers <= 1 or len(folders) <= 1:
        return [pack_video(f, force=force) for f in folders]
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(n_workers) as pool:
        return pool.starmap(pack_video, [(f, force) for f in folders])


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Pack a preprocessed frames dataset for decode-free "
                    "training (see data/packed.py).")
    parser.add_argument("db_dir", help="frames root ({db_dir}/{video_id}/...)")
    parser.add_argument("--subset", default=None, help="subset .lst file")
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--force", action="store_true",
                        help="re-pack videos that already have a pack")
    args = parser.parse_args(argv)
    packed = pack_all(args.db_dir, args.subset, args.num_workers, args.force)
    print(f"packed {len(packed)} videos under {args.db_dir}")


if __name__ == "__main__":
    main()
