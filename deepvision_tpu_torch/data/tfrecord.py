"""TFRecord framing and the ``tf.train.Example`` codec, the port's copy of
``deepvision_tpu/data/tfrecord.py``.

The on-disk contract is the same, byte for byte:

- TFRecord framing: ``<u64 len><u32 masked-crc32c(len)><bytes><u32
  masked-crc32c(bytes)>``, the masked Castagnoli CRC;
- ``tf.train.Example`` protobuf wire format (varint and length-delimited
  fields; FloatList and Int64List packed or not).

The CRC32C is compiled (``csrc/crc32c.cpp``, built on first use by the
system C++ compiler, ``ops/_build.py``): the reader checks both CRCs of
every record, as tf.data does, and the slicing-by-8 tables in Python
(:func:`crc32c_reference`, the plain twin the tests hold it to) manage
about 22 records of 262 KB a second. A missing compiler raises. A CRC
that does not match raises :class:`DataLossError`, as tf.data's
``DataLossError`` stops a run.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = ["DataLossError", "crc32c", "crc32c_reference", "crc32c_native",
           "write_records", "read_records", "encode_example",
           "decode_example", "FloatList", "Int64List", "BytesList"]


class DataLossError(OSError):
    """A record whose length or payload fails its CRC, or a truncated
    file."""


# --------------------------------------------------------------------------
# CRC32C (Castagnoli)
# --------------------------------------------------------------------------

_lock = threading.Lock()
_native = None
_CRC_TABLES = None


def crc32c_native():
    """The compiled CRC32C library (built on first use)."""
    global _native
    with _lock:
        if _native is None:
            from deepvision_tpu_torch.ops._build import load_library

            lib = load_library("crc32c")
            lib.dv_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.dv_crc32c.restype = ctypes.c_uint32
            lib.dv_crc32c_hardware.argtypes = []
            lib.dv_crc32c_hardware.restype = ctypes.c_int
            _native = lib
        return _native


def crc32c(data) -> int:
    """CRC32C of a bytes-like ``data``, compiled."""
    lib = crc32c_native()
    view = np.frombuffer(data, dtype=np.uint8)  # no copy
    if not len(view):
        return 0
    return lib.dv_crc32c(view.ctypes.data, len(view))


def _crc_tables():
    """Slicing-by-8 tables (8x256) for :func:`crc32c_reference`."""
    global _CRC_TABLES
    if _CRC_TABLES is None:
        poly = 0x82F63B78
        base = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            base.append(c)
        tables = [base]
        for k in range(1, 8):
            prev = tables[k - 1]
            tables.append([base[prev[n] & 0xFF] ^ (prev[n] >> 8)
                           for n in range(256)])
        _CRC_TABLES = tables
    return _CRC_TABLES


def crc32c_reference(data) -> int:
    """CRC32C in plain Python, slicing-by-8: the twin of the JAX
    package's fallback and of :func:`crc32c`."""
    t = _crc_tables()
    crc = 0xFFFFFFFF
    mv = memoryview(data).cast("B")
    n8 = len(mv) - len(mv) % 8
    for i in range(0, n8, 8):
        b0, b1, b2, b3, b4, b5, b6, b7 = mv[i : i + 8]
        crc ^= b0 | b1 << 8 | b2 << 16 | b3 << 24
        crc = (t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF]
               ^ t[5][(crc >> 16) & 0xFF] ^ t[4][crc >> 24]
               ^ t[3][b4] ^ t[2][b5] ^ t[1][b6] ^ t[0][b7])
    for b in mv[n8:]:
        crc = t[0][(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# TFRecord framing
# --------------------------------------------------------------------------


def frame_record(rec: bytes) -> bytes:
    """One record in TFRecord framing: length, its CRC, payload, its
    CRC."""
    header = struct.pack("<Q", len(rec))
    return (header + struct.pack("<I", _masked_crc(header)) + rec
            + struct.pack("<I", _masked_crc(rec)))


def write_records(path: str | Path, records) -> None:
    with open(path, "wb") as f:
        for rec in records:
            f.write(frame_record(rec))


def read_records(path: str | Path, *, verify: bool = True,
                 fault_injector=None) -> Iterator[bytes]:
    """The records of one TFRecord file, in order. ``verify`` checks the
    length's and the payload's CRC of every record. ``fault_injector``
    (``resilience.FaultInjector``) consults its ``data_io`` site before
    every record read, as the JAX reader does (the retry belongs to the
    consumer: a generator that raised cannot resume)."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            if fault_injector is not None:
                fault_injector.check_io(what=f"record read ({path})")
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise DataLossError(f"{path}: truncated length header at "
                                    f"offset {offset}")
            (length,) = struct.unpack("<Q", header)
            tail = f.read(4)
            data = f.read(length)
            tail2 = f.read(4)
            if len(tail) < 4 or len(data) < length or len(tail2) < 4:
                raise DataLossError(f"{path}: truncated record at offset "
                                    f"{offset}")
            if verify:
                if _masked_crc(header) != struct.unpack("<I", tail)[0]:
                    raise DataLossError(f"{path}: length CRC mismatch at "
                                        f"offset {offset}")
                if _masked_crc(data) != struct.unpack("<I", tail2)[0]:
                    raise DataLossError(f"{path}: data CRC mismatch at "
                                        f"offset {offset}")
            offset += 16 + length
            yield data


# --------------------------------------------------------------------------
# Minimal protobuf wire codec for tf.train.Example
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _ld(num: int, payload: bytes) -> bytes:  # length-delimited field
    return _field(num, 2) + _varint(len(payload)) + payload


class FloatList(list):
    """Typed wrapper: encodes as FloatList even when empty."""


class Int64List(list):
    """Typed wrapper: encodes as Int64List even when empty."""


class BytesList(list):
    """Typed wrapper: encodes as BytesList even when empty."""


def _encode_feature(value) -> bytes:
    """value: list of bytes/str -> BytesList; float -> FloatList;
    int -> Int64List. The typed wrappers fix the wire type (and are the
    only way to encode an empty feature)."""
    if not isinstance(value, (list, tuple)):
        value = [value]

    def as_bytes():
        items = b"".join(
            _ld(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in value)
        return _ld(1, items)  # BytesList at field 1

    def as_floats():
        packed = struct.pack(f"<{len(value)}f", *map(float, value))
        return _ld(2, _ld(1, packed))  # FloatList(packed) at field 2

    def as_ints():
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                          for v in value)
        return _ld(3, _ld(1, packed))  # Int64List(packed) at field 3

    if isinstance(value, BytesList):
        return as_bytes()
    if isinstance(value, FloatList):
        return as_floats()
    if isinstance(value, Int64List):
        return as_ints()
    if not value:
        raise TypeError(
            "empty untyped feature list: wrap with tfrecord.FloatList/"
            "Int64List/BytesList to fix the wire type")
    first = value[0]
    if isinstance(first, (bytes, bytearray, str)):
        return as_bytes()
    if isinstance(first, float):
        return as_floats()
    if isinstance(first, (int, bool, np.integer)):
        return as_ints()
    raise TypeError(f"unsupported feature value type {type(first)}")


def encode_example(features: dict) -> bytes:
    """dict -> serialized tf.train.Example bytes."""
    entries = b""
    for key in sorted(features):
        feat = _encode_feature(features[key])
        entry = _ld(1, key.encode()) + _ld(2, feat)
        entries += _ld(1, entry)  # map entry, Features.feature field 1
    return _ld(1, entries)  # Example.features field 1


def _iter_fields(buf):
    """(field number, wire type, value) of each field of ``buf`` (a
    memoryview: length-delimited values are views, not copies)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _decode_feature(buf, views: bool = False):
    for num, _, val in _iter_fields(buf):
        if num == 1:  # BytesList
            return [v if views else bytes(v)
                    for n, _, v in _iter_fields(val) if n == 1]
        if num == 2:  # FloatList, packed or repeated
            floats = []
            for n, wire, v in _iter_fields(val):
                if n != 1:
                    continue
                if wire == 2:
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:  # wire 5: single fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if num == 3:  # Int64List, packed or repeated varints
            ints = []
            for n, wire, v in _iter_fields(val):
                if n != 1:
                    continue
                if wire == 2:
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        ints.append(x - (1 << 64) if x >= 1 << 63 else x)
                else:
                    x = v if isinstance(v, int) else 0
                    ints.append(x - (1 << 64) if x >= 1 << 63 else x)
            return ints
    return []


def decode_example(data, *, views: bool = False) -> dict:
    """serialized tf.train.Example -> {key: list of values}. ``views``:
    BytesList values are memoryviews into ``data`` rather than copies (a
    raw frame is then read in place)."""
    out = {}
    for num, _, features_buf in _iter_fields(memoryview(data)):
        if num != 1:
            continue
        for n2, _, entry in _iter_fields(features_buf):
            if n2 != 1:
                continue
            key = None
            feat = memoryview(b"")
            for n3, _, v in _iter_fields(entry):
                if n3 == 1:
                    key = bytes(v).decode()
                elif n3 == 2:
                    feat = v
            if key is not None:
                out[key] = _decode_feature(feat, views)
    return out
