"""Minimal TensorBoard event writer (no tensorflow/tensorboardX): the port's
copy of spatialaudiogen_tpu.utils.tensorboard, the same bytes for the same
events.

Implements just enough of the TFRecord framing (length + masked crc32c) and
the tensorflow.Event/Summary protobuf wire format to emit scalar curves that
TensorBoard renders — restoring the reference's TB observability
(train.py:157-163) without any TF dependency.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- crc32c (Castagnoli), table-driven ---
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire helpers ---

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes_field(field, payload)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    summary_value = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time) + _varint_field(2, int(step))
            + _bytes_field(5, summary))


def _histo_event(tag: str, values, step: int, wall_time: float) -> bytes:
    """tensorflow.HistogramProto in Summary.Value field 5 (summary.proto):
    min/max/num/sum/sum_squares + packed bucket_limit/bucket doubles.
    TensorBoard renders whatever bucketing it is given; numpy's
    equal-width histogram reads fine for weight distributions."""
    import numpy as np

    v = np.asarray(values, np.float64).ravel()
    n_bins = int(min(64, max(1, round(np.sqrt(v.size)))))
    counts, edges = np.histogram(v, bins=n_bins)
    histo = (_double_field(1, float(v.min())) + _double_field(2, float(v.max()))
             + _double_field(3, float(v.size)) + _double_field(4, float(v.sum()))
             + _double_field(5, float((v * v).sum()))
             + _packed_doubles(6, edges[1:]) + _packed_doubles(7, counts))
    summary_value = _bytes_field(1, tag.encode()) + _bytes_field(5, histo)
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time) + _varint_field(2, int(step))
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class TBEventWriter:
    """Append-only events.out.tfevents.* writer for scalar summaries."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fn = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fn)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None):
        self._write_record(_scalar_event(tag, value, step,
                                         wall_time if wall_time is not None
                                         else time.time()))

    def add_histogram(self, tag: str, values, step: int,
                      wall_time: float | None = None):
        """Histogram summary of an array (the reference's verbosity-gated
        variable histograms, dnn.py:692-709). Non-finite entries are
        dropped first — np.histogram raises on NaN/Inf, and a diverging
        run must abort through the trainer's loss guard, not through its
        logging path. Arrays with nothing finite are skipped."""
        import numpy as np

        v = np.asarray(values)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        self._write_record(_histo_event(tag, v, step,
                                        wall_time if wall_time is not None
                                        else time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_records(path: str):
    """Parse a tfevents file back into raw event payloads (crc-checked)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header crc mismatch"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "payload crc mismatch"
            out.append(payload)
    return out


def _iter_fields(msg: bytes):
    """(field, wire, value) triples of one protobuf message (test helper)."""
    pos = 0
    while pos < len(msg):
        key = 0
        shift = 0
        while True:
            b = msg[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = msg[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            (val,) = struct.unpack("<d", msg[pos: pos + 8])
            pos += 8
        elif wire == 5:
            (val,) = struct.unpack("<f", msg[pos: pos + 4])
            pos += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = msg[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = msg[pos: pos + ln]
            pos += ln
        else:
            return
        yield field, wire, val


def decode_histograms(path: str):
    """(tag, min, max, num, n_buckets) tuples from a tfevents file (tests)."""
    out = []
    for payload in read_records(path):
        for field, wire, summary in _iter_fields(payload):
            if field != 5 or wire != 2:
                continue
            for f2, w2, value_msg in _iter_fields(summary):
                if f2 != 1 or w2 != 2:
                    continue
                tag = histo = None
                for f3, w3, v3 in _iter_fields(value_msg):
                    if f3 == 1 and w3 == 2:
                        tag = v3.decode()
                    elif f3 == 5 and w3 == 2:
                        histo = v3
                if tag is None or histo is None:
                    continue
                fields = {f: v for f, _, v in _iter_fields(histo)}
                n_buckets = len(fields.get(7, b"")) // 8
                out.append((tag, fields.get(1), fields.get(2),
                            fields.get(3), n_buckets))
    return out


def decode_scalars(path: str):
    """Extract (tag, value, step) triples from a tfevents file (for tests)."""
    triples = []
    for payload in read_records(path):
        step = None
        tag = None
        value = None
        pos = 0
        while pos < len(payload):
            key = payload[pos]
            field, wire = key >> 3, key & 7
            pos += 1
            if wire == 0:  # varint
                val = 0
                shift = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    val |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = val
            elif wire == 1:
                pos += 8
            elif wire == 5:
                pos += 4
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                sub = payload[pos: pos + ln]
                pos += ln
                if field == 5:  # summary -> value -> tag/simple_value
                    spos = 0
                    while spos < len(sub):
                        skey = sub[spos]
                        spos += 1
                        sln = sub[spos]
                        spos += 1
                        val_msg = sub[spos: spos + sln]
                        spos += sln
                        vpos = 0
                        while vpos < len(val_msg):
                            vkey = val_msg[vpos]
                            vfield, vwire = vkey >> 3, vkey & 7
                            vpos += 1
                            if vwire == 2:
                                vln = val_msg[vpos]
                                vpos += 1
                                if vfield == 1:
                                    tag = val_msg[vpos: vpos + vln].decode()
                                vpos += vln
                            elif vwire == 5:
                                if vfield == 2:
                                    (value,) = struct.unpack(
                                        "<f", val_msg[vpos: vpos + 4])
                                vpos += 4
                            elif vwire == 1:
                                vpos += 8
                            else:
                                vpos = len(val_msg)
        if tag is not None and value is not None:
            triples.append((tag, value, step))
    return triples
