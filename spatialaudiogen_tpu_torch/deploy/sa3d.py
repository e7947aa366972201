"""MP4 spatial-media metadata injection (SA3D + spherical video V1; the
port's copy of spatialaudiogen_tpu.deploy.sa3d).

A small self-contained ISO-BMFF box editor replacing the vendored
spatial-media package the reference shells out to (myutils.py:304-311,
3rd-party/spatial-media): parses the top-level/container box tree, appends an
SA3D box (github.com/google/spatial-media "Spatial Audio" RFC; field layout
as in its mpeg/sa3d.py:87-112) to every mp4a sample entry, and a spherical
V1 uuid+XML box to every video trak, rewriting ancestor box sizes.

Limitations (documented): 32-bit box sizes only (no box > 4 GiB), no co64
offset fixups needed because nothing before mdat moves when moov follows
mdat; when moov precedes mdat, stco/co64 chunk offsets are rewritten by the
injected byte delta.
"""

from __future__ import annotations

import struct

CONTAINER_BOXES = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts"}
SOUND_SAMPLE_ENTRIES = {b"mp4a", b"lpcm", b"sowt", b"twos"}
SPHERICAL_UUID = bytes.fromhex("ffcc82638f554a938814587a02521fdd")

def make_spherical_xml(stereo_mode: str = "none") -> bytes:
    """Spherical video V1 RDF/XML (spatial-media metadata_utils semantics:
    a StereoMode tag is added for top-bottom / left-right, omitted for
    mono/none)."""
    assert stereo_mode in ("none", "top-bottom", "left-right")
    stereo = b""
    if stereo_mode != "none":
        stereo = (b"<GSpherical:StereoMode>" + stereo_mode.encode() +
                  b"</GSpherical:StereoMode>")
    return (
        b"<?xml version=\"1.0\"?>"
        b"<rdf:SphericalVideo xmlns:rdf=\"http://www.w3.org/1999/02/22-rdf-syntax-ns#\""
        b" xmlns:GSpherical=\"http://ns.google.com/videos/1.0/spherical/\">"
        b"<GSpherical:Spherical>true</GSpherical:Spherical>"
        b"<GSpherical:Stitched>true</GSpherical:Stitched>"
        b"<GSpherical:StitchingSoftware>spatialaudiogen_tpu</GSpherical:StitchingSoftware>"
        b"<GSpherical:ProjectionType>equirectangular</GSpherical:ProjectionType>"
        + stereo +
        b"</rdf:SphericalVideo>")


SPHERICAL_XML = make_spherical_xml()


class Box:
    def __init__(self, box_type: bytes, payload: bytes | None = None,
                 children: list | None = None, header_extra: bytes = b""):
        self.type = box_type
        self.payload = payload if payload is not None else b""
        self.children = children if children is not None else []
        self.header_extra = header_extra  # bytes between header and children (e.g. stsd count)

    def size(self) -> int:
        return 8 + len(self.header_extra) + len(self.payload) + sum(c.size() for c in self.children)

    def serialize(self) -> bytes:
        body = self.header_extra + self.payload + b"".join(c.serialize() for c in self.children)
        return struct.pack(">I", 8 + len(body)) + self.type + body

    def find_all(self, box_type: bytes) -> list:
        out = [self] if self.type == box_type else []
        for c in self.children:
            out.extend(c.find_all(box_type))
        return out

    def __repr__(self):
        return f"Box({self.type.decode(errors='replace')}, {self.size()}b, {len(self.children)} children)"


def _parse_children(data: bytes, box_type: bytes) -> tuple[bytes, list]:
    """Returns (header_extra, children) for a container-ish box payload."""
    offset = 0
    header_extra = b""
    if box_type == b"stsd":
        header_extra, offset = data[:8], 8          # version/flags + entry_count
    elif box_type in SOUND_SAMPLE_ENTRIES:
        header_extra, offset = data[:28], 28        # AudioSampleEntry fields
    children = []
    pos = offset
    while pos + 8 <= len(data):
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        if size < 8 or pos + size > len(data):
            return data, []  # not a clean child sequence; treat as opaque
        children.append(parse_box(data[pos:pos + size]))
        pos += size
    if pos != len(data):
        return data, []
    return header_extra, children


def parse_box(blob: bytes) -> Box:
    size = struct.unpack(">I", blob[:4])[0]
    btype = blob[4:8]
    assert size == len(blob), (size, len(blob))
    data = blob[8:]
    if btype in CONTAINER_BOXES or btype == b"stsd" or btype in SOUND_SAMPLE_ENTRIES:
        header_extra, children = _parse_children(data, btype)
        if children:
            return Box(btype, b"", children, header_extra)
    return Box(btype, data)


def parse_top_level(data: bytes) -> list:
    boxes = []
    pos = 0
    while pos + 8 <= len(data):
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        assert size >= 8, "64-bit box sizes not supported"
        boxes.append(parse_box(data[pos:pos + size]))
        pos += size
    assert pos == len(data), "trailing bytes in mp4"
    return boxes


def make_sa3d_box(order: int = 1, ordering: int = 0, normalization: int = 0,
                  channel_map=None) -> Box:
    """SA3D leaf box: ambisonic type periphonic, ACN/SN3D by default."""
    num_channels = (order + 1) ** 2 if channel_map is None else len(channel_map)
    if channel_map is None:
        channel_map = list(range(num_channels))
    payload = struct.pack(">BB", 0, 0)                 # version, ambisonic_type=periphonic
    payload += struct.pack(">I", order)
    payload += struct.pack(">BB", ordering, normalization)
    payload += struct.pack(">I", num_channels)
    payload += b"".join(struct.pack(">I", c) for c in channel_map)
    return Box(b"SA3D", payload)


def make_spherical_uuid_box(stereo_mode: str = "none") -> Box:
    return Box(b"uuid", SPHERICAL_UUID + make_spherical_xml(stereo_mode))


def _trak_is_audio(trak: Box) -> bool:
    return bool(trak.find_all(b"smhd") or
                any(trak.find_all(t) for t in SOUND_SAMPLE_ENTRIES))


def inject_spatial_metadata(data: bytes, spatial_audio: bool = True,
                            spherical_video: bool = True, order: int = 1,
                            stereo_mode: str = "none") -> bytes:
    """Returns new MP4 bytes with SA3D and/or spherical uuid boxes injected."""
    boxes = parse_top_level(data)
    moov = next((b for b in boxes if b.type == b"moov"), None)
    assert moov is not None, "no moov box found"
    injected = 0
    old_moov_size = moov.size()
    for trak in moov.find_all(b"trak"):
        if spatial_audio and _trak_is_audio(trak):
            for entry_type in SOUND_SAMPLE_ENTRIES:
                for entry in trak.find_all(entry_type):
                    if not entry.find_all(b"SA3D"):
                        entry.children.append(make_sa3d_box(order=order))
                        injected += 1
        elif spherical_video and not _trak_is_audio(trak):
            if not any(c.type == b"uuid" for c in trak.children):
                trak.children.append(make_spherical_uuid_box(stereo_mode))
                injected += 1

    if injected:
        delta = moov.size() - old_moov_size
        moov_index = boxes.index(moov)
        mdat_index = next((i for i, b in enumerate(boxes) if b.type == b"mdat"), None)
        if mdat_index is not None and moov_index < mdat_index and delta:
            _shift_chunk_offsets(moov, delta)
    return b"".join(b.serialize() for b in boxes)


def _shift_chunk_offsets(moov: Box, delta: int):
    """Rewrite stco/co64 offsets when media data moves by `delta` bytes."""
    for stco in moov.find_all(b"stco"):
        head, rest = stco.payload[:8], stco.payload[8:]
        count = struct.unpack(">I", head[4:8])[0]
        offsets = struct.unpack(f">{count}I", rest[: 4 * count])
        stco.payload = head + struct.pack(f">{count}I", *[o + delta for o in offsets]) \
            + rest[4 * count:]
    for co64 in moov.find_all(b"co64"):
        head, rest = co64.payload[:8], co64.payload[8:]
        count = struct.unpack(">I", head[4:8])[0]
        offsets = struct.unpack(f">{count}Q", rest[: 8 * count])
        co64.payload = head + struct.pack(f">{count}Q", *[o + delta for o in offsets]) \
            + rest[8 * count:]


def inject_file(input_fn: str, output_fn: str, spatial_audio: bool = True,
                spherical_video: bool = True, order: int = 1,
                stereo_mode: str = "none"):
    data = open(input_fn, "rb").read()
    out = inject_spatial_metadata(data, spatial_audio, spherical_video, order,
                                  stereo_mode)
    with open(output_fn, "wb") as f:
        f.write(out)


def describe_file(input_fn: str) -> list:
    """Human-readable description of the spatial metadata in an MP4 —
    the spatial-media CLI's print mode (spatialmedia/__main__.py parse
    path). Returns a list of strings; malformed/non-MP4 files are reported
    per file instead of raising (this is the CLI's default action on
    arbitrary user files)."""
    try:
        boxes = parse_top_level(open(input_fn, "rb").read())
        moov = next((b for b in boxes if b.type == b"moov"), None)
    except Exception:
        return [f"{input_fn}: could not parse box structure (not an MP4?)"]
    lines = []
    if moov is None:
        return [f"{input_fn}: no moov box (not an MP4?)"]
    for i, trak in enumerate(moov.find_all(b"trak")):
        kind = "audio" if _trak_is_audio(trak) else "video"
        found = False
        for sa3d in trak.find_all(b"SA3D"):
            p = sa3d.payload
            try:
                order = struct.unpack(">I", p[2:6])[0]
                ordering, norm = struct.unpack(">BB", p[6:8])
                n_ch = struct.unpack(">I", p[8:12])[0]
                cmap = struct.unpack(f">{n_ch}I", p[12: 12 + 4 * n_ch])
            except struct.error:
                lines.append(f"{input_fn}: trak {i} ({kind}): malformed SA3D "
                             f"box ({len(p)} payload bytes)")
                found = True
                continue
            lines.append(
                f"{input_fn}: trak {i} ({kind}): SA3D order={order} "
                f"ordering={'ACN' if ordering == 0 else ordering} "
                f"normalization={'SN3D' if norm == 0 else norm} "
                f"channel_map={list(cmap)}")
            found = True
        for child in trak.children:
            if child.type == b"uuid" and child.payload.startswith(SPHERICAL_UUID):
                xml = child.payload[len(SPHERICAL_UUID):].decode("utf-8", "replace")
                lines.append(f"{input_fn}: trak {i} ({kind}): spherical V1 XML: {xml}")
                found = True
        if not found:
            lines.append(f"{input_fn}: trak {i} ({kind}): no spatial metadata")
    return lines
