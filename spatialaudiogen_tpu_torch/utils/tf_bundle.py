"""TF-free reader/writer for TensorFlow TensorBundle checkpoints (the
port's copy of spatialaudiogen_tpu.utils.tf_bundle, numpy only).

The released spatialaudiogen models (reference README.md:70-78) are TF1
`model.ckpt-N.{index,data-00000-of-00001}` bundles. This module parses that
on-disk format directly so conversion needs no TensorFlow install:

  * the `.index` file is an LSM-style immutable table (the leveldb/TF
    `table_format`): prefix-compressed key/value blocks, each followed by a
    1-byte compression tag + masked-CRC32C trailer, an index block of block
    handles, and a 48-byte footer ending in the magic 0xdb4775248b80fb57
    (tensorflow/core/lib/io/format.cc semantics);
  * values are wire-format protobufs — key "" maps to BundleHeaderProto
    (num_shards/endianness/version) and every other key is a tensor name
    mapping to BundleEntryProto (dtype/shape/shard_id/offset/size/crc32c)
    from tensorflow/core/protobuf/tensor_bundle.proto;
  * tensor bytes live in the `.data-SSSSS-of-NNNNN` shard files at
    [offset, offset+size), row-major little-endian.

A matching writer exports the port's weights back into a TF1-loadable
bundle (cli/export_to_tf_bundle.py; cli/import_tf_checkpoint.py reads one).
Only the features TF1 checkpoints actually use are implemented: no block
compression (TF's BundleWriter writes the index with kNoCompression), no
tensor slices, little-endian hosts.

The files written are byte for byte those of the JAX package's writer.
The one difference is speed: CRC32C over 32 KB or more runs in numpy
lanes (`crc32c`) instead of a Python loop over every byte
(tools/time_tf_bundle_crc.py times both).
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48  # 2 BlockHandles padded to 40 bytes + 8-byte magic
_BLOCK_TRAILER_LEN = 5  # 1-byte compression type + 4-byte masked crc32c

# tensorflow/core/framework/types.proto DataType -> numpy
DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    19: np.dtype("<f2"),  # DT_HALF
}
_DTYPE_CODES = {v: k for k, v in DTYPES.items()}


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), with TF/leveldb masking.
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> np.ndarray:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = np.empty(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c_bytewise(data, reg: int) -> int:
    """The CRC register after `data`, from register `reg` (no inversions)."""
    table = _CRC_TABLE
    for b in data:
        reg = (reg >> 8) ^ int(table[(reg ^ b) & 0xFF])
    return reg


# The register update is linear over GF(2): the register after bytes A || B
# is Z_|B|(register after A) ^ (register after B from 0), where Z_n is the
# linear map of feeding n zero bytes. A 32x32 bit map is kept as four
# 256-entry tables, one per byte of its argument.
_BYTE_BITS = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)


def _tables(columns: np.ndarray) -> np.ndarray:
    """(32,) images of the single bits -> (4, 256) byte tables of the map."""
    return np.stack([np.bitwise_xor.reduce(
        np.where(_BYTE_BITS, columns[8 * k: 8 * k + 8], np.uint32(0)), axis=1)
        for k in range(4)])


def _apply(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (tables[0][x & 0xFF] ^ tables[1][(x >> 8) & 0xFF]
            ^ tables[2][(x >> 16) & 0xFF] ^ tables[3][x >> 24])


@functools.lru_cache(maxsize=256)
def _zeros_tables(n: int) -> np.ndarray:
    """Byte tables of Z_n, by squaring the map of one zero byte."""
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    one = _tables((bits >> 8) ^ _CRC_TABLE[bits & 0xFF])
    result = _tables(bits)   # identity
    while n:
        if n & 1:
            result = _tables(_apply(one, _apply(result, bits)))
        n >>= 1
        if n:
            one = _tables(_apply(one, _apply(one, bits)))
    return result


def _crc32c_lanes(data) -> int:
    """The register after `data` from 0, with the bytes cut into a power of
    two of equal lanes run side by side and the lanes' registers folded
    pairwise through Z. Zero bytes in front of the first lane keep its
    register at 0, so the data is padded there to fill the lanes."""
    n = len(data)
    lanes = 1 << min(16, (n // 64).bit_length() - 1)
    width = -(-n // lanes)
    buf = np.zeros(lanes * width, np.uint8)
    buf[lanes * width - n:] = np.frombuffer(data, np.uint8)
    reg = np.zeros(lanes, np.uint32)
    table = _CRC_TABLE
    for col in buf.reshape(lanes, width).T.copy():
        reg = (reg >> 8) ^ table[(reg ^ col) & 0xFF]
    span = width
    while len(reg) > 1:
        reg = _apply(_zeros_tables(span), reg[0::2]) ^ reg[1::2]
        span *= 2
    return int(reg[0])


def crc32c(data: bytes, crc: int = 0) -> int:
    reg = crc ^ 0xFFFFFFFF
    if len(data) < 1 << 15:
        reg = _crc32c_bytewise(data, reg)
    else:
        reg = int(_apply(_zeros_tables(len(data)), np.array([reg], np.uint32))[0]) \
            ^ _crc32c_lanes(data)
    return reg ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """leveldb/TF crc mask: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Varints + protobuf wire format (decode + the little we need to encode).
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.

    wire 0 -> int, wire 1 -> 8 raw bytes, wire 2 -> bytes, wire 5 -> 4 raw
    bytes. Groups (3/4) are not used by any TF checkpoint proto.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _field(field: int, wire: int, payload: bytes | int) -> bytes:
    tag = _write_varint(field << 3 | wire)
    if wire == 0:
        return tag + _write_varint(payload)
    if wire == 5:
        return tag + payload
    return tag + _write_varint(len(payload)) + payload


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    dims = []
    for field, _, value in _iter_proto_fields(buf):
        if field == 2:  # repeated Dim
            size = 0
            for dfield, _, dvalue in _iter_proto_fields(value):
                if dfield == 1:
                    size = dvalue
            dims.append(size)
    return tuple(dims)


class BundleEntry:
    """Decoded BundleEntryProto (tensor_bundle.proto)."""

    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c")

    def __init__(self, buf: bytes):
        self.dtype = 0
        self.shape: tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0
        for field, wire, value in _iter_proto_fields(buf):
            if field == 1:
                self.dtype = value
            elif field == 2:
                self.shape = _parse_shape(value)
            elif field == 3:
                self.shard_id = value
            elif field == 4:
                self.offset = value
            elif field == 5:
                self.size = value
            elif field == 6:
                self.crc32c = struct.unpack("<I", value)[0]
            elif field == 7:
                raise NotImplementedError("sliced bundle entries")

    def serialize(self) -> bytes:
        shape = b"".join(
            _field(2, 2, _field(1, 0, d)) for d in self.shape)
        out = _field(1, 0, self.dtype) + _field(2, 2, shape)
        if self.shard_id:
            out += _field(3, 0, self.shard_id)
        if self.offset:
            out += _field(4, 0, self.offset)
        out += _field(5, 0, self.size)
        out += _field(6, 5, struct.pack("<I", self.crc32c))
        return out


def _parse_header(buf: bytes) -> dict:
    header = {"num_shards": 1, "endianness": 0}
    for field, _, value in _iter_proto_fields(buf):
        if field == 1:
            header["num_shards"] = value
        elif field == 2:
            header["endianness"] = value
    return header


# ---------------------------------------------------------------------------
# Immutable-table (.index file) reader.
# ---------------------------------------------------------------------------

def _decode_block(raw: bytes, verify_crc: bool = True) -> bytes:
    """Strip and check the 5-byte trailer; reject compressed blocks."""
    contents, ctype, crc = raw[:-5], raw[-5], struct.unpack("<I", raw[-4:])[0]
    if verify_crc and masked_crc32c(raw[:-4]) != crc:
        raise ValueError("block checksum mismatch")
    if ctype == 0:
        return contents
    if ctype == 1:
        raise NotImplementedError("snappy-compressed index blocks")
    raise ValueError(f"unknown block compression type {ctype}")


def _iter_block_entries(contents: bytes):
    """Yield (key, value) pairs from a prefix-compressed block."""
    (num_restarts,) = struct.unpack("<I", contents[-4:])
    data_end = len(contents) - 4 * (num_restarts + 1)
    pos, key = 0, b""
    while pos < data_end:
        shared, pos = _read_varint(contents, pos)
        non_shared, pos = _read_varint(contents, pos)
        value_len, pos = _read_varint(contents, pos)
        key = key[:shared] + contents[pos:pos + non_shared]
        pos += non_shared
        value = contents[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_block_handle(buf: bytes, pos: int = 0) -> tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_index_file(index_fn: str, verify_crc: bool = True) -> dict:
    """Parse a bundle .index file -> {'header': dict, 'entries': {name: BundleEntry}}."""
    blob = open(index_fn, "rb").read()
    if len(blob) < _FOOTER_LEN:
        raise ValueError(f"{index_fn}: too short to be a table file")
    footer = blob[-_FOOTER_LEN:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != TABLE_MAGIC:
        raise ValueError(f"{index_fn}: bad table magic {magic:#x}")
    _, _, pos = _read_block_handle(footer)          # metaindex (unused)
    index_off, index_size, _ = _read_block_handle(footer, pos)

    index_block = _decode_block(
        blob[index_off:index_off + index_size + _BLOCK_TRAILER_LEN], verify_crc)
    header, entries = None, {}
    for _, handle in _iter_block_entries(index_block):
        off, size, _ = _read_block_handle(handle)
        data_block = _decode_block(
            blob[off:off + size + _BLOCK_TRAILER_LEN], verify_crc)
        for key, value in _iter_block_entries(data_block):
            if key == b"":
                header = _parse_header(value)
            else:
                entries[key.decode()] = BundleEntry(value)
    if header is None:
        raise ValueError(f"{index_fn}: missing bundle header entry")
    if header["endianness"] != 0:
        raise NotImplementedError("big-endian checkpoint")
    return {"header": header, "entries": entries}


# ---------------------------------------------------------------------------
# Public checkpoint API.
# ---------------------------------------------------------------------------

def _shard_fn(prefix: str, shard_id: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard_id:05d}-of-{num_shards:05d}"


def latest_checkpoint(model_dir: str) -> str | None:
    """Resolve `model_dir` to a checkpoint prefix like tf.train.latest_checkpoint.

    Reads the CheckpointState text file (`checkpoint`) if present, else picks
    the highest-numbered model.ckpt-*.index.
    """
    state_fn = os.path.join(model_dir, "checkpoint")
    if os.path.exists(state_fn):
        for line in open(state_fn):
            if line.startswith("model_checkpoint_path:"):
                path = line.split(":", 1)[1].strip().strip('"')
                if not os.path.isabs(path):
                    path = os.path.join(model_dir, path)
                return path
    candidates = []
    for fn in os.listdir(model_dir):
        if fn.endswith(".index"):
            stem = fn[:-len(".index")]
            step = stem.rsplit("-", 1)[-1]
            candidates.append((int(step) if step.isdigit() else -1, stem))
    if not candidates:
        return None
    return os.path.join(model_dir, max(candidates)[1])


def load_tf_checkpoint(path: str, verify_crc: bool = False) -> dict:
    """Load a TF1 TensorBundle into {var_name: np.ndarray}.

    `path` is a checkpoint prefix (`.../model.ckpt-152000`), an .index file,
    or a directory containing a checkpoint. Tensor-data CRC verification is
    off by default (pure-python crc32c over hundreds of MB is slow); index
    block CRCs are always checked.
    """
    if os.path.isdir(path):
        resolved = latest_checkpoint(path)
        if resolved is None:
            raise FileNotFoundError(f"no TF checkpoint under {path}")
        path = resolved
    if path.endswith(".index"):
        path = path[:-len(".index")]
    index = read_index_file(path + ".index", verify_crc=True)
    num_shards = index["header"]["num_shards"]

    shards = {}
    out = {}
    for name, entry in index["entries"].items():
        if entry.shard_id not in shards:
            shards[entry.shard_id] = np.memmap(
                _shard_fn(path, entry.shard_id, num_shards), np.uint8, "r")
        shard = shards[entry.shard_id]
        raw = bytes(shard[entry.offset:entry.offset + entry.size])
        if verify_crc and entry.crc32c and masked_crc32c(raw) != entry.crc32c:
            raise ValueError(f"{name}: tensor data checksum mismatch")
        if entry.dtype not in DTYPES:
            raise NotImplementedError(f"{name}: dtype code {entry.dtype}")
        arr = np.frombuffer(raw, DTYPES[entry.dtype])
        out[name] = arr.reshape(entry.shape)
    return out


# ---------------------------------------------------------------------------
# Writer (fixtures + export back to TF1-loadable bundles).
# ---------------------------------------------------------------------------

class _BlockBuilder:
    """Builds one prefix-compressed block (restart interval like TF's 16)."""

    def __init__(self, restart_interval: int = 16):
        self.buf = bytearray()
        self.restarts = [0]
        self.last_key = b""
        self.counter = 0
        self.restart_interval = restart_interval

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.restart_interval:
            max_shared = min(len(self.last_key), len(key))
            while shared < max_shared and self.last_key[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += _write_varint(shared)
        self.buf += _write_varint(len(key) - shared)
        self.buf += _write_varint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        return out + struct.pack("<I", len(self.restarts))


def _emit_block(out: bytearray, contents: bytes) -> bytes:
    """Append contents + trailer; return the encoded BlockHandle."""
    handle = _write_varint(len(out)) + _write_varint(len(contents))
    tagged = contents + b"\x00"
    out += tagged
    out += struct.pack("<I", masked_crc32c(tagged))
    return handle


def write_index_file(index_fn: str, entries: dict, num_shards: int = 1,
                     block_size: int = 4096) -> None:
    """Write a .index table: header entry at key "" + sorted tensor entries."""
    records = [(b"", _field(1, 0, num_shards) +
                _field(3, 2, _field(1, 0, 1)))]  # header + VersionDef{producer:1}
    for name in sorted(entries):
        records.append((name.encode(), entries[name].serialize()))

    out = bytearray()
    index = _BlockBuilder(restart_interval=1)
    block = _BlockBuilder()
    for key, value in records:
        if len(block.buf) >= block_size and block.counter:
            handle = _emit_block(out, block.finish())
            index.add(block.last_key, handle)  # last key is a valid separator
            block = _BlockBuilder()
        block.add(key, value)
    if block.counter:
        handle = _emit_block(out, block.finish())
        index.add(block.last_key, handle)

    meta_handle = _emit_block(out, _BlockBuilder().finish())
    index_handle = _emit_block(out, index.finish())
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", TABLE_MAGIC)
    out += footer
    with open(index_fn, "wb") as f:
        f.write(out)


def save_tf_checkpoint(prefix: str, tensors: dict) -> None:
    """Write {name: array} as a single-shard TF1 TensorBundle at `prefix`."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    entries = {}
    offset = 0
    with open(_shard_fn(prefix, 0, 1), "wb") as data_f:
        # TF writes tensors in sorted-name order; offsets are cumulative.
        for name in sorted(tensors):
            # NOT ascontiguousarray: that promotes 0-d arrays to 1-d and
            # would record scalars (e.g. global_step) with shape (1,)
            arr = np.asarray(tensors[name])
            if arr.dtype == np.float64:
                arr = arr.astype("<f4")  # TF1 models are float32
            dtype = np.dtype(arr.dtype.str.replace(">", "<"))
            raw = arr.astype(dtype, copy=False).tobytes()
            entry = BundleEntry(b"")
            entry.dtype = _DTYPE_CODES[dtype]
            entry.shape = arr.shape
            entry.offset = offset
            entry.size = len(raw)
            entry.crc32c = masked_crc32c(raw)
            entries[name] = entry
            data_f.write(raw)
            offset += len(raw)
    write_index_file(prefix + ".index", entries)
    state_fn = os.path.join(os.path.dirname(os.path.abspath(prefix)), "checkpoint")
    base = os.path.basename(prefix)
    with open(state_fn, "w") as f:
        f.write(f'model_checkpoint_path: "{base}"\n'
                f'all_model_checkpoint_paths: "{base}"\n')
