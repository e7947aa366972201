"""Training windows rebuilt from a pack, for the reference.

A row the feeder gave the step carries its id, "{clip} {t}": the clip and
the chunk time. What it does not carry is the random azimuth rotation the
feeder drew for it. That angle is recovered from the row itself, by the
least-squares fit of the rotated (Y, X) pair to the pack's; the window is
then rebuilt from the pack with that angle (audio rotated, frames and flow
rolled by the matching pixel count, flow decoded), and the largest
difference between the rebuilt window and the row is returned beside it.
The semantics are those of the reference feeder (feeder.py:164-278):
window from round((t - context/2) * rate), zero-padded past the clip's
ends; frame floor(t * fps), clamped to the last; a rotation a turns
(Y, X) into (cos a Y + sin a X, cos a X - sin a Y) and rolls the
equirectangular frame by -int(a / 2pi * width) pixels."""

from __future__ import annotations

import json
import os

import numpy as np

from port_bench.reference.geometry import Geometry


class Pack:
    def __init__(self, folder: str):
        d = os.path.join(folder, "packed")
        with open(os.path.join(d, "meta.json")) as f:
            self.meta = json.load(f)
        self.audio = np.load(os.path.join(d, "ambix.npy"), mmap_mode="r")
        self.video = np.load(os.path.join(d, "video.npy"), mmap_mode="r")
        self.flow = self.lims = None
        if os.path.exists(os.path.join(d, "flow.npy")):
            self.flow = np.load(os.path.join(d, "flow.npy"), mmap_mode="r")
            self.lims = np.load(os.path.join(d, "flow_lims.npy"))

    def audio_window(self, t: float, g: Geometry) -> np.ndarray:
        start = g.chunk_start(t)
        out = np.zeros((g.snd_size, 4), np.float32)
        lo, hi = max(start, 0), min(start + g.snd_size, self.audio.shape[0])
        if hi > lo:
            out[lo - start: hi - start] = self.audio[lo:hi, :4].astype(np.float32) / 32768.0
        return out


def rotation_of(row: np.ndarray, plain: np.ndarray) -> float:
    """The azimuth a with row's (Y, X) = R(a) applied to plain's."""
    y, x = plain[:, 1].astype(np.float64), plain[:, 3].astype(np.float64)
    y2, x2 = row[:, 1].astype(np.float64), row[:, 3].astype(np.float64)
    c = np.dot(y2, y) + np.dot(x2, x)
    s = np.dot(y2, x) - np.dot(x2, y)
    return float(np.arctan2(s, c))


def rotate(chunk: np.ndarray, a: float) -> np.ndarray:
    rot = np.eye(4)
    rot[1, 1] = rot[3, 3] = np.cos(a)
    rot[1, 3], rot[3, 1] = np.sin(a), -np.sin(a)
    return (chunk @ rot.T.astype(np.float32)).astype(np.float32)


def decode_flow(pixels: np.ndarray, lim: np.ndarray) -> np.ndarray:
    px = pixels.astype(np.float32)
    mag = px[..., 2] * (lim[1] - lim[0]) / 255.0 + lim[0]
    ang = px[..., 0] * (2 * np.pi) / 255.0
    return np.stack([mag * np.cos(ang), mag * np.sin(ang), mag], -1).astype(np.float32)


def rebuild_batch(db: str, rows: dict, g: Geometry, encoders: tuple,
                  packs: dict | None = None) -> tuple[dict, float]:
    """(the batch rebuilt from the pack for the rows' ids, the largest
    absolute difference from `rows`). `rows` holds the feeder's numpy
    arrays: id, ambix, audio_mask, and video / flow where the model reads
    them."""
    packs = {} if packs is None else packs
    out = {k: [] for k in ("ambix",) + tuple(e for e in ("video", "flow") if e in encoders)}
    gap = 0.0
    for i, rid in enumerate(rows["id"]):
        clip, t = rid.split()[0], float(rid.split()[1])
        if clip not in packs:
            packs[clip] = Pack(os.path.join(db, clip))
        pack = packs[clip]
        plain = pack.audio_window(t, g)
        a = rotation_of(rows["ambix"][i], plain)
        ambix = rotate(plain, a)
        out["ambix"].append(ambix)
        gap = max(gap, float(np.abs(ambix - rows["ambix"][i]).max()))
        frame = min(max(int(t * g.video_rate), 0), pack.meta["video_frames"] - 1)
        width = pack.video.shape[2]
        # the roll is an integer part of the angle: where the recovered
        # angle sits within rounding of a step, either neighbour may be it
        rolls = [-int((a + d) / (2.0 * np.pi) * width) for d in (0.0, -1e-6, 1e-6)]
        for enc, frames in (("video", pack.video), ("flow", pack.flow)):
            if enc not in out:
                continue
            cands = []
            for r in dict.fromkeys(rolls):
                x = np.roll(np.asarray(frames[frame: frame + g.vid_dur]), r, axis=2)
                cands.append(decode_flow(x, pack.lims[frame]) if enc == "flow" else x)
            diffs = [float(np.abs(c.astype(np.float32) - rows[enc][i].astype(np.float32)).max())
                     for c in cands]
            best = int(np.argmin(diffs))
            out[enc].append(cands[best])
            gap = max(gap, diffs[best])
    batch = {k: np.stack(v) for k, v in out.items()}
    batch["audio_mask"] = np.ones((len(rows["id"]), 4), np.float32)
    return batch, gap
