"""A stand-in `ffmpeg` for tests of the mux paths on hosts without one.

`install(folder)` writes an executable `ffmpeg` script into `folder` (put
it first on PATH) and a minimal MP4 beside it. Each call appends its argv
to `folder/calls.jsonl` and then:
  * the mux (two -i inputs, audio then video) keeps a copy of both inputs
    as `mixN_audio.wav` / `mixN_video.mp4` (N counts calls from 1) and
    writes the minimal MP4 to its output;
  * any other call (split, trim) copies its one input to its output.
"""

from __future__ import annotations

import json
import os
import re
import struct
import sys


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def fake_mp4() -> bytes:
    """ftyp + moov (an audio trak with an mp4a sample entry and a chunk
    offset table, a video trak with avc1) + mdat: enough of an MP4 for the
    SA3D and spherical-video injection."""
    stco = _box(b"stco", struct.pack(">II", 0, 2) + struct.pack(">II", 100, 200))
    mp4a = _box(b"mp4a", b"\x00" * 28 + _box(b"esds", b"\x00" * 8))
    stsd_a = _box(b"stsd", struct.pack(">II", 0, 1) + mp4a)
    trak_a = _box(b"trak", _box(b"mdia", _box(b"minf", _box(b"smhd", b"\x00" * 4)
                                              + _box(b"stbl", stsd_a + stco))))
    stsd_v = _box(b"stsd", struct.pack(">II", 0, 1) + _box(b"avc1", b"\x00" * 70))
    trak_v = _box(b"trak", _box(b"mdia", _box(b"minf", _box(b"vmhd", b"\x00" * 4)
                                              + _box(b"stbl", stsd_v))))
    moov = _box(b"moov", _box(b"mvhd", b"\x00" * 100) + trak_a + trak_v)
    return _box(b"ftyp", b"isom\x00\x00\x02\x00mp41") + moov + _box(b"mdat", b"\x00" * 64)


STUB = """#!{python}
import json, os, shutil, sys
folder = {folder!r}
args = sys.argv[1:]
with open(os.path.join(folder, "calls.jsonl"), "a") as f:
    f.write(json.dumps(args) + "\\n")
n = sum(1 for _ in open(os.path.join(folder, "calls.jsonl")))
inputs = [args[i + 1] for i, a in enumerate(args) if a == "-i"]
if len(inputs) == 2:
    shutil.copy(inputs[0], os.path.join(folder, "mix%d_audio.wav" % n))
    shutil.copy(inputs[1], os.path.join(folder, "mix%d_video.mp4" % n))
    shutil.copy(os.path.join(folder, "fake.mp4"), args[-1])
else:
    shutil.copy(inputs[0], args[-1])
"""


def install(folder) -> str:
    """Write the stub into `folder` (created); -> the folder, for PATH."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "fake.mp4"), "wb") as f:
        f.write(fake_mp4())
    path = os.path.join(folder, "ffmpeg")
    with open(path, "w") as f:
        f.write(STUB.format(python=sys.executable, folder=folder))
    os.chmod(path, 0o755)
    return folder


def calls(folder) -> list:
    """The recorded argv lists, in order ([] if ffmpeg never ran)."""
    fn = os.path.join(str(folder), "calls.jsonl")
    if not os.path.exists(fn):
        return []
    with open(fn) as f:
        return [json.loads(line) for line in f]


def normalised(argv: list, out_fn: str) -> list:
    """argv with the run's own temporary names and its output path replaced
    by placeholders, so that two runs' commands compare equal."""
    subs = ((re.escape(out_fn), "<out>"), (r"\S*/sag360_[^/]+/", "<tmp>/"),
            (r"\S*/sag_[^/]*\.wav", "<ambix.wav>"), (r"\S*/sag_[^/]*\.mp4", "<trimmed.mp4>"))
    out = []
    for arg in argv:
        for pattern, repl in subs:
            arg = re.sub(pattern, repl, arg)
        out.append(arg)
    return out
