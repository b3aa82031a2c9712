"""Pure-python TFRecord + tf.train.Example(float_list) codec.

The reference PUGeo pipeline depends on TF1's TFRecordDataset
(`dataset/pugeo/fetcher.py:222-240`); this module removes the tensorflow
dependency: a TFRecord is length-prefixed framing (u64 length, masked-crc32c
of the length, payload, masked-crc32c of the payload) around serialized
`tf.train.Example` protos, and the PUGeo examples only use fixed-length
float features — so a ~100-line codec covers the format.

Reading skips CRC verification (corrupt shards raise on framing instead);
writing emits valid CRCs so produced shards stay TF-compatible.

The port's copy of `puflow_tpu.data.tfrecord` (pure Python and numpy).
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-based — needed for the TFRecord framing masks
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------
def read_records(path: str):
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,) = struct.unpack("<Q", head[:8])
            payload = f.read(length)
            f.read(4)  # data crc
            if len(payload) < length:
                raise EOFError(f"truncated record in {path}")
            yield payload


def write_records(path: str, payloads) -> None:
    with open(path, "wb") as f:
        for p in payloads:
            head = struct.pack("<Q", len(p))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format walker for Example{Features{map<str,Feature>}}
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos: pos + length]
            pos += length
        elif wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, val
        elif wire == 5:  # 32-bit
            yield field, buf[pos: pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, buf[pos: pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example_floats(payload: bytes) -> dict:
    """Serialized tf.train.Example -> {feature_name: float32 array}."""
    out = {}
    for f_ex, features in _iter_fields(payload):
        if f_ex != 1:
            continue
        for f_map, entry in _iter_fields(features):
            if f_map != 1:
                continue
            name, feature = None, None
            for f_e, v in _iter_fields(entry):
                if f_e == 1:
                    name = v.decode()
                elif f_e == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for f_feat, flist in _iter_fields(feature):
                if f_feat != 2:  # float_list
                    continue
                for f_fl, data in _iter_fields(flist):
                    if f_fl == 1:
                        out[name] = np.frombuffer(data, dtype="<f4").copy()
    return out


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def build_example_floats(features: dict) -> bytes:
    """{name: float array} -> serialized tf.train.Example bytes."""
    entries = b""
    for name, arr in features.items():
        data = np.asarray(arr, dtype="<f4").tobytes()
        float_list = _ld(1, data)
        feature = _ld(2, float_list)
        entry = _ld(1, name.encode()) + _ld(2, feature)
        entries += _ld(1, entry)
    return _ld(1, entries)
