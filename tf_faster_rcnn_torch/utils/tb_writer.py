"""Native TensorBoard event-file writer (no TF or tensorboard dependency).

A copy of ``tf_faster_rcnn_tpu/utils/tb_writer.py``
(``tests/test_torch_train_utils.py`` holds the two writers' files equal
byte for byte). The reference's observability channel is TensorBoard
FileWriters fed with scalar, histogram and image summaries (network.py:
437-450, train_val.py:148-151). This module writes the same on-disk
artifact, ``events.out.tfevents.*`` files in TFRecord framing with
hand-encoded Event/Summary protobufs, so TensorBoard reads the port's run
dirs unchanged. PNG encoding imports PIL when an image is written.

Wire format notes:
* TFRecord framing: u64-LE length, masked-crc32c(length), payload,
  masked-crc32c(payload); mask(c) = ((c>>15 | c<<17) + 0xa282ead8) mod 2^32.
* Protos encoded by hand (field numbers from tensorflow's event.proto /
  summary.proto): Event{1: wall_time double, 2: step int64,
  3: file_version string, 5: summary}; Summary{1: repeated Value};
  Value{1: tag, 2: simple_value float, 4: Image, 5: HistogramProto};
  Image{1: height, 2: width, 3: colorspace, 4: encoded_image_string};
  HistogramProto{1: min, 2: max, 3: num, 4: sum, 5: sum_squares,
  6: bucket_limit packed double, 7: bucket packed double}.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import threading
import time

import numpy as np

__all__ = ["TBEventWriter", "crc32c"]


# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected poly 0x82F63B78), software table version.

def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding.

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _string_field(field: int, s: str) -> bytes:
    return _bytes_field(field, s.encode("utf-8"))


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes_field(field, payload)


# ---------------------------------------------------------------------------
# Summary encoders.

def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, _string_field(1, tag) + _float_field(2, value))


def _histogram_value(tag: str, values: np.ndarray) -> bytes:
    """HistogramProto with TF's default exponential bucketing (×1.1)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,), np.float64)
    limits = [-1e20]
    x = 1e-12
    pos = [x]
    while x < 1e20:
        x *= 1.1
        pos.append(x)
    limits += [-p for p in reversed(pos)] + [0.0] + pos + [1e20]
    limits = np.asarray(sorted(limits))
    counts, _ = np.histogram(v, bins=np.concatenate([[-np.inf], limits]))
    nz = np.nonzero(counts)[0]
    if nz.size:  # trim empty head/tail buckets like TF does
        lo, hi = nz[0], nz[-1] + 1
        counts, limits = counts[lo:hi], limits[lo:hi]
    histo = (_double_field(1, float(v.min())) +
             _double_field(2, float(v.max())) +
             _double_field(3, float(v.size)) +
             _double_field(4, float(v.sum())) +
             _double_field(5, float((v * v).sum())) +
             _packed_doubles(6, limits) +
             _packed_doubles(7, counts))
    return _bytes_field(1, _string_field(1, tag) + _bytes_field(5, histo))


def _png_encode(img: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.uint8(np.clip(img, 0, 255))).save(buf, format="PNG")
    return buf.getvalue()


def _image_value(tag: str, img_hwc: np.ndarray) -> bytes:
    h, w = img_hwc.shape[:2]
    depth = 1 if img_hwc.ndim == 2 else img_hwc.shape[2]
    image = (_int_field(1, h) + _int_field(2, w) + _int_field(3, depth) +
             _bytes_field(4, _png_encode(img_hwc)))
    return _bytes_field(1, _string_field(1, tag) + _bytes_field(4, image))


def _event(step: int, summary: bytes = b"", file_version: str = "",
           wall_time: float = None) -> bytes:
    out = _double_field(1, time.time() if wall_time is None else wall_time)
    if step:
        out += _int_field(2, int(step))
    if file_version:
        out += _string_field(3, file_version)
    if summary:
        out += _bytes_field(5, summary)
    return out


# ---------------------------------------------------------------------------

class TBEventWriter(object):
    """Append-only writer of a TensorBoard events file in ``logdir``.

    Equivalent surface to the reference's tf.summary.FileWriter use: scalar,
    histogram, and image summaries keyed by tag and global step.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self._f = open(os.path.join(logdir, fname), "ab")
        self._lock = threading.Lock()
        self._write(_event(0, file_version="brain.Event:2"))
        self.flush()

    def _write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", _masked_crc(header)))
            self._f.write(record)
            self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_event(step, _scalar_value(tag, float(value))))

    def add_scalars(self, values: dict, step: int, prefix: str = ""):
        summary = b"".join(
            _scalar_value(prefix + k if not prefix or prefix.endswith("/")
                          else f"{prefix}/{k}", float(v))
            for k, v in values.items())
        self._write(_event(step, summary))

    def add_histogram(self, tag: str, values, step: int):
        self._write(_event(step, _histogram_value(tag, np.asarray(values))))

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int):
        self._write(_event(step, _image_value(tag, img_hwc)))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        self.flush()
        self._f.close()
