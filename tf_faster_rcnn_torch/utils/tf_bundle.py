"""Pure-Python reader for TensorFlow TensorBundle checkpoints (.ckpt).

A copy of ``tf_faster_rcnn_tpu/utils/tf_bundle.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_weights_import.py`` holds the
two readers equal on bundles that real TensorFlow wrote). The reference
trains and ships TF1 ``.ckpt`` checkpoints (Saver V2:
``<prefix>.index`` + ``<prefix>.data-00000-of-NNNNN``), and its released
models come only in this format; this reader needs no TensorFlow, so the
weight import (``utils/slim_import.py``, ``tools/convert_weights.py``)
reads a real checkpoint wherever the port runs.

Format (tensorflow/core/util/tensor_bundle):
* ``.index`` is a LevelDB-style SSTable: prefix-compressed key/value blocks
  with a restart array, each block followed by a compression-type byte and
  a masked crc32c; a fixed 48-byte footer holds the metaindex/index block
  handles and the table magic. Keys are tensor names (the empty key is the
  bundle header); values are serialized BundleHeaderProto/BundleEntryProto.
* ``.data-*`` shards hold the raw little-endian tensor bytes at
  (shard_id, offset, size) from each entry.

The proto fields are hand-decoded (varint wire format): the three messages
involved are tiny and frozen. Snappy block decompression is implemented
inline for tables written with compression on.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

__all__ = ["read_tf_checkpoint", "list_tf_checkpoint", "is_tf_checkpoint"]

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset that appears in weight
# checkpoints; tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (raw bits; see _to_array)
    19: np.dtype("<f2"),   # DT_HALF
    17: np.dtype("<u2"),   # DT_UINT16
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}
_DT_BFLOAT16 = 14


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """LEB128 unsigned varint at pos -> (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _snappy_decompress(src: bytes) -> bytes:
    """Raw snappy block format (format_description.txt): varint length then
    literal / copy tags."""
    n, pos = _varint(src, 0)
    out = bytearray()
    while pos < len(src):
        tag = src[pos]
        pos += 1
        t = tag & 3
        if t == 0:                      # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(src[pos:pos + extra], "little") + 1
                pos += extra
            out += src[pos:pos + length]
            pos += length
        else:
            if t == 1:                  # copy, 1-byte offset
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | src[pos]
                pos += 1
            elif t == 2:                # copy, 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(src[pos:pos + 2], "little")
                pos += 2
            else:                       # copy, 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(src[pos:pos + 4], "little")
                pos += 4
            for _ in range(length):     # may overlap itself
                out.append(out[-offset])
    if len(out) != n:
        raise ValueError(f"snappy: got {len(out)} bytes, expected {n}")
    return bytes(out)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents at a BlockHandle; trailing byte is compression type."""
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return block
    if ctype == 1:
        return _snappy_decompress(block)
    raise ValueError(f"unsupported table block compression {ctype}")


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate (key, value) over a prefix-compressed table block."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack("<I", block[-4:])[0]
    limit = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value) over a proto message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _varint(buf, pos)
        elif wt == 1:
            v = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_shape(buf: bytes):
    """TensorShapeProto: field 2 = repeated Dim{1: size}."""
    dims = []
    for field, _, v in _proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _, v2 in _proto_fields(v):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


class _BundleEntry:
    __slots__ = ("dtype_enum", "shape", "shard_id", "offset", "size")

    def __init__(self, buf: bytes):
        self.dtype_enum = 0
        self.shape = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        for field, _, v in _proto_fields(buf):
            if field == 1:
                self.dtype_enum = v
            elif field == 2:
                self.shape = _parse_shape(v)
            elif field == 3:
                self.shard_id = v
            elif field == 4:
                self.offset = v
            elif field == 5:
                self.size = v


def _index_entries(prefix: str) -> Dict[str, _BundleEntry]:
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    footer = data[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{prefix}.index is not an SSTable: magic "
                         f"{magic:#x}")
    pos = 0
    _, pos = _varint(footer, pos)          # metaindex handle offset
    _, pos = _varint(footer, pos)          # metaindex handle size
    idx_off, pos = _varint(footer, pos)    # index block handle
    idx_size, pos = _varint(footer, pos)
    entries: Dict[str, _BundleEntry] = {}
    num_shards = 1
    index_block = _read_block(data, idx_off, idx_size)
    for _, handle in _block_entries(index_block):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        for key, value in _block_entries(_read_block(data, off, size)):
            name = key.decode("utf-8")
            if name == "":
                for field, _, v in _proto_fields(value):  # BundleHeaderProto
                    if field == 1:
                        num_shards = v
                continue
            # a TF2 object-graph key (".../.ATTRIBUTES/VARIABLE_VALUE")
            # stays whole: the slim mapping never reads it
            entries[name] = _BundleEntry(value)
    entries["__num_shards__"] = num_shards  # type: ignore
    return entries


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def _to_array(raw: bytes, entry: _BundleEntry) -> np.ndarray:
    if entry.dtype_enum == _DT_BFLOAT16:
        bits = np.frombuffer(raw, np.dtype("<u2")).astype(np.uint32) << 16
        return bits.view(np.float32).astype(np.float32).reshape(entry.shape)
    dt = _DTYPES.get(entry.dtype_enum)
    if dt is None:
        raise ValueError(f"unsupported tensor dtype enum {entry.dtype_enum}")
    return np.frombuffer(raw, dt).reshape(entry.shape)


def is_tf_checkpoint(path: str) -> bool:
    """True if path is a TensorBundle prefix (``<path>.index`` exists)."""
    return os.path.exists(path + ".index")


def list_tf_checkpoint(prefix: str) -> Dict[str, Tuple[tuple, int]]:
    """{tensor_name: (shape, dtype_enum)} without reading tensor data."""
    entries = _index_entries(prefix)
    return {k: (e.shape, e.dtype_enum) for k, e in entries.items()
            if k != "__num_shards__"}


def read_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Read every dense tensor of a TensorBundle checkpoint into numpy."""
    entries = _index_entries(prefix)
    num_shards = entries.pop("__num_shards__")  # type: ignore
    shards = {}
    out: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        if e.dtype_enum == 7:  # DT_STRING (e.g. TF2 object-graph proto)
            continue
        if e.shard_id not in shards:
            with open(_shard_path(prefix, e.shard_id, num_shards), "rb") as f:
                shards[e.shard_id] = f.read()
        raw = shards[e.shard_id][e.offset:e.offset + e.size]
        out[name] = _to_array(raw, e)
    return out
