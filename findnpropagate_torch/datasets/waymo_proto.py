"""Waymo Open Dataset frame decoding without the devkit — port of
findnpropagate_tpu/datasets/waymo_proto.py (numpy and the standard
library).

Two layers:

  1. TFRecord framing — length-prefixed records (uint64 LE length, uint32
     masked CRC32C of the length, payload, uint32 masked CRC32C of the
     payload). The reader checks the lengths and, with `check_crc`, the
     CRCs (CRC32C, Castagnoli polynomial).
  2. Protobuf wire format — a generic tag / varint / length-delimited
     decoder and field maps transcribed from the public
     `waymo_open_dataset/dataset.proto` / `label.proto` (Apache-2.0).

Only the fields info generation needs are mapped: Frame.context (laser
calibrations), timestamp, pose, lasers (compressed range images and the
TOP lidar's pixel pose) and laser_labels. The field numbers stand next to
each accessor. An encoder of the same subset (`emit_*`, `encode_*`) writes
synthetic sequences (scene -> Frame bytes -> TFRecord) for the tests and
the smoke run.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

_CRC_POLY = 0x82F63B78          # CRC32C, reflected
_CRC_TABLE = None
_SHIFT_TABLES = {}
_LANES = 4096                   # lanes of the vectorised CRC


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.zeros(256, np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc_register(crc: int, data) -> int:
    """The CRC register after feeding `data` byte by byte from `crc`."""
    tab = _crc_table()
    for b in bytes(data):
        crc = int(tab[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc


def _shift_tables(n: int):
    """The register's map over n zero bytes, which is linear over GF(2),
    as four byte-indexed tables: Z(s) = T0[s & 255] ^ T1[s >> 8 & 255] ^
    T2[s >> 16 & 255] ^ T3[s >> 24]."""
    if n not in _SHIFT_TABLES:
        tab = _crc_table()
        basis = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
        for _ in range(n):
            basis = tab[basis & 0xFF] ^ (basis >> np.uint32(8))
        tables = []
        for k in range(4):
            t = np.zeros(256, np.uint32)
            for v in range(1, 256):
                low = v & -v
                t[v] = t[v ^ low] ^ basis[8 * k + low.bit_length() - 1]
            tables.append([int(x) for x in t])
        _SHIFT_TABLES[n] = tables
    return _SHIFT_TABLES[n]


def _crc32c(data: bytes) -> int:
    """CRC32C of `data` (init and final xor 0xFFFFFFFF). Long inputs run in
    _LANES lanes at once: the register's update is linear over GF(2), so
    crc(A + B) = Z_|B|(crc(A)) ^ crc_from_zero(B); each lane computes its
    chunk's crc_from_zero in numpy, and the chunks are then chained
    through the zero-byte map Z of one chunk's length."""
    data = memoryview(bytes(data))
    n = len(data)
    chunk = n // _LANES
    if chunk < 64:
        return _crc_register(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    head = n - chunk * _LANES
    crc = _crc_register(0xFFFFFFFF, data[:head])
    tab = _crc_table()
    lanes = np.frombuffer(data[head:], np.uint8).reshape(_LANES, chunk)
    regs = np.zeros(_LANES, np.uint32)
    for i in range(chunk):
        regs = tab[(regs ^ lanes[:, i]) & 0xFF] ^ (regs >> np.uint32(8))
    t0, t1, t2, t3 = _shift_tables(chunk)
    for r in regs.tolist():
        crc = (t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF]
               ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24]) ^ r
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecord(path, check_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if check_crc:
                (lc,) = struct.unpack("<I", header[8:12])
                if lc != _masked_crc(header[:8]):
                    raise ValueError("TFRecord length CRC mismatch")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError("truncated TFRecord payload")
            footer = f.read(4)
            if check_crc:
                (dc,) = struct.unpack("<I", footer)
                if dc != _masked_crc(payload):
                    raise ValueError("TFRecord data CRC mismatch")
            yield payload


def write_tfrecord(path, payloads) -> None:
    """Write payloads with the standard TFRecord framing."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


# ---------------------------------------------------------------------------
# Generic protobuf wire decoding
# ---------------------------------------------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def parse_fields(buf: bytes) -> Dict[int, List[Tuple[int, object]]]:
    """Decode one message into {field_number: [(wire_type, raw_value)]}.

    raw_value: int for varint, bytes for length-delimited, 8/4 raw bytes for
    fixed64/fixed32 (caller interprets as double/float/etc.).
    """
    out: Dict[int, List[Tuple[int, object]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _WIRE_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _WIRE_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(fnum, []).append((wt, val))
    return out


def _first(fields, num, default=None):
    vals = fields.get(num)
    return vals[-1][1] if vals else default


def _varint_field(fields, num, default=0) -> int:
    vals = fields.get(num)
    return int(vals[-1][1]) if vals else default


def _double_field(fields, num, default=0.0) -> float:
    vals = fields.get(num)
    if not vals:
        return default
    wt, raw = vals[-1]
    return struct.unpack("<d", raw)[0]


def _packed_doubles(fields, num) -> np.ndarray:
    """repeated double: packed (one LEN blob) or unpacked (many I64)."""
    vals = fields.get(num, [])
    out = []
    for wt, raw in vals:
        if wt == _WIRE_LEN:
            out.append(np.frombuffer(raw, dtype="<f8"))
        else:
            out.append(np.frombuffer(raw, dtype="<f8", count=1))
    return np.concatenate(out) if out else np.zeros((0,), np.float64)


def _packed_floats(fields, num) -> np.ndarray:
    vals = fields.get(num, [])
    out = []
    for wt, raw in vals:
        if wt == _WIRE_LEN:
            out.append(np.frombuffer(raw, dtype="<f4"))
        else:
            out.append(np.frombuffer(raw, dtype="<f4", count=1))
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def _packed_varints(fields, num) -> List[int]:
    vals = fields.get(num, [])
    out: List[int] = []
    for wt, raw in vals:
        if wt == _WIRE_LEN:
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                out.append(v)
        else:
            out.append(int(raw))
    return out


# ---------------------------------------------------------------------------
# Waymo message views (field numbers from the public protos)
# ---------------------------------------------------------------------------

# waymo_open_dataset/dataset.proto LaserName.Name
LASER_UNKNOWN, LASER_TOP, LASER_FRONT = 0, 1, 2
LASER_SIDE_LEFT, LASER_SIDE_RIGHT, LASER_REAR = 3, 4, 5

# label.proto Label.Type — index -> class string
TYPE_NAMES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


def decode_matrix_float(buf: bytes) -> np.ndarray:
    """MatrixFloat { repeated float data = 1 [packed]; MatrixShape shape = 2 }
    MatrixShape { repeated int32 dims = 1 }"""
    f = parse_fields(buf)
    data = _packed_floats(f, 1)
    shape_msg = _first(f, 2, b"")
    dims = _packed_varints(parse_fields(shape_msg), 1)
    return data.reshape(dims) if dims else data


def _decode_compressed_matrix(blob: bytes) -> np.ndarray:
    return decode_matrix_float(zlib.decompress(blob))


def _transform_4x4(buf: bytes) -> np.ndarray:
    """Transform { repeated double transform = 1 } — 16 row-major values."""
    vals = _packed_doubles(parse_fields(buf), 1)
    if vals.size != 16:
        return np.eye(4)
    return vals.reshape(4, 4)


@dataclass
class LaserCalibration:
    """LaserCalibration { name=1; beam_inclinations=2;
    beam_inclination_min=3; beam_inclination_max=4; extrinsic=5 }"""
    name: int = 0
    beam_inclinations: np.ndarray = field(
        default_factory=lambda: np.zeros((0,)))
    beam_inclination_min: float = 0.0
    beam_inclination_max: float = 0.0
    extrinsic: np.ndarray = field(default_factory=lambda: np.eye(4))

    @classmethod
    def parse(cls, buf: bytes) -> "LaserCalibration":
        f = parse_fields(buf)
        return cls(
            name=_varint_field(f, 1),
            beam_inclinations=_packed_doubles(f, 2),
            beam_inclination_min=_double_field(f, 3),
            beam_inclination_max=_double_field(f, 4),
            extrinsic=_transform_4x4(_first(f, 5, b"")),
        )


@dataclass
class RangeImage:
    """RangeImage { range_image=1 [deprecated]; range_image_compressed=2;
    camera_projection_compressed=3; range_image_pose_compressed=4 }"""
    range_image: np.ndarray | None = None
    pose: np.ndarray | None = None

    @classmethod
    def parse(cls, buf: bytes) -> "RangeImage":
        f = parse_fields(buf)
        ri = None
        comp = _first(f, 2)
        if comp:
            ri = _decode_compressed_matrix(comp)
        elif _first(f, 1):
            ri = decode_matrix_float(_first(f, 1))
        pose_blob = _first(f, 4)
        pose = _decode_compressed_matrix(pose_blob) if pose_blob else None
        return cls(range_image=ri, pose=pose)


@dataclass
class Laser:
    """Laser { name=1; ri_return1=2; ri_return2=3 }"""
    name: int = 0
    ri_return1: RangeImage | None = None
    ri_return2: RangeImage | None = None

    @classmethod
    def parse(cls, buf: bytes) -> "Laser":
        f = parse_fields(buf)
        r1 = _first(f, 2)
        r2 = _first(f, 3)
        return cls(
            name=_varint_field(f, 1),
            ri_return1=RangeImage.parse(r1) if r1 else None,
            ri_return2=RangeImage.parse(r2) if r2 else None,
        )


@dataclass
class Label:
    """Label { box=1; metadata=2; type=3; id=4;
    detection_difficulty_level=5; tracking_difficulty_level=6;
    num_lidar_points_in_box=7 }
    Box { center_x=1; center_y=2; center_z=3; length=4; width=5;
    height=6; heading=7 } — public label.proto: "length: dim x.
    width: dim y." (tests/fixtures/waymo_golden.tfrecord, written with no
    code of this module, pins the numbers)
    Metadata { speed_x=1; speed_y=2; accel_x=3; accel_y=4 }"""
    center: np.ndarray = field(default_factory=lambda: np.zeros(3))
    length: float = 0.0
    width: float = 0.0
    height: float = 0.0
    heading: float = 0.0
    type: int = 0
    id: str = ""
    detection_difficulty_level: int = 0
    tracking_difficulty_level: int = 0
    num_lidar_points_in_box: int = 0
    speed: np.ndarray = field(default_factory=lambda: np.zeros(2))
    accel: np.ndarray = field(default_factory=lambda: np.zeros(2))

    @classmethod
    def parse(cls, buf: bytes) -> "Label":
        f = parse_fields(buf)
        box = parse_fields(_first(f, 1, b""))
        meta = parse_fields(_first(f, 2, b""))
        return cls(
            center=np.array([_double_field(box, 1), _double_field(box, 2),
                             _double_field(box, 3)]),
            length=_double_field(box, 4),
            width=_double_field(box, 5),
            height=_double_field(box, 6),
            heading=_double_field(box, 7),
            type=_varint_field(f, 3),
            id=_first(f, 4, b"").decode("utf-8", "replace"),
            detection_difficulty_level=_varint_field(f, 5),
            tracking_difficulty_level=_varint_field(f, 6),
            num_lidar_points_in_box=_varint_field(f, 7),
            speed=np.array([_double_field(meta, 1), _double_field(meta, 2)]),
            accel=np.array([_double_field(meta, 3), _double_field(meta, 4)]),
        )


@dataclass
class Frame:
    """Frame { context=1; timestamp_micros=2; pose=3; images=4; lasers=5;
    laser_labels=6 } — Context { name=1; camera_calibrations=2;
    laser_calibrations=3 }. Only generation-relevant fields are decoded."""
    context_name: str = ""
    timestamp_micros: int = 0
    pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    laser_calibrations: List[LaserCalibration] = field(default_factory=list)
    lasers: List[Laser] = field(default_factory=list)
    laser_labels: List[Label] = field(default_factory=list)

    @classmethod
    def parse(cls, buf: bytes) -> "Frame":
        f = parse_fields(buf)
        ctx = parse_fields(_first(f, 1, b""))
        return cls(
            context_name=_first(ctx, 1, b"").decode("utf-8", "replace"),
            timestamp_micros=_varint_field(f, 2),
            pose=_transform_4x4(_first(f, 3, b"")),
            laser_calibrations=[LaserCalibration.parse(v)
                                for _, v in ctx.get(3, [])],
            lasers=[Laser.parse(v) for _, v in f.get(5, [])],
            laser_labels=[Label.parse(v) for _, v in f.get(6, [])],
        )


# ---------------------------------------------------------------------------
# Encoder of the same subset (synthetic sequences)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(num: int, wt: int) -> bytes:
    return _varint((num << 3) | wt)


def emit_len(num: int, payload: bytes) -> bytes:
    return _tag(num, _WIRE_LEN) + _varint(len(payload)) + payload


def emit_varint(num: int, v: int) -> bytes:
    return _tag(num, _WIRE_VARINT) + _varint(v)


def emit_double(num: int, v: float) -> bytes:
    return _tag(num, _WIRE_I64) + struct.pack("<d", v)


def emit_packed_doubles(num: int, arr) -> bytes:
    return emit_len(num, np.asarray(arr, "<f8").tobytes())


def encode_matrix_float(arr: np.ndarray) -> bytes:
    shape = b"".join(emit_varint(1, int(d)) for d in arr.shape)
    return (emit_len(1, np.asarray(arr, "<f4").ravel().tobytes())
            + emit_len(2, shape))


def encode_transform(mat4: np.ndarray) -> bytes:
    return emit_packed_doubles(1, np.asarray(mat4, np.float64).ravel())


def encode_laser_calibration(name, extrinsic, beam_inclinations=None,
                             incl_min=0.0, incl_max=0.0) -> bytes:
    out = emit_varint(1, name)
    if beam_inclinations is not None and len(beam_inclinations):
        out += emit_packed_doubles(2, beam_inclinations)
    out += emit_double(3, incl_min) + emit_double(4, incl_max)
    out += emit_len(5, encode_transform(extrinsic))
    return out


def encode_range_image(range_image: np.ndarray,
                       pose: np.ndarray | None = None) -> bytes:
    out = emit_len(2, zlib.compress(
        encode_matrix_float(np.asarray(range_image, np.float32))))
    if pose is not None:
        out += emit_len(4, zlib.compress(
            encode_matrix_float(np.asarray(pose, np.float32))))
    return out


def encode_laser(name: int, ri1: bytes, ri2: bytes | None = None) -> bytes:
    out = emit_varint(1, name) + emit_len(2, ri1)
    if ri2 is not None:
        out += emit_len(3, ri2)
    return out


def encode_label(center, lwh, heading, type_idx, obj_id,
                 difficulty=0, tracking_difficulty=0, num_points=0,
                 speed=(0.0, 0.0), accel=(0.0, 0.0)) -> bytes:
    box = (emit_double(1, center[0]) + emit_double(2, center[1])
           + emit_double(3, center[2]) + emit_double(4, lwh[0])
           + emit_double(5, lwh[1]) + emit_double(6, lwh[2])
           + emit_double(7, heading))
    meta = (emit_double(1, speed[0]) + emit_double(2, speed[1])
            + emit_double(3, accel[0]) + emit_double(4, accel[1]))
    return (emit_len(1, box) + emit_len(2, meta) + emit_varint(3, type_idx)
            + emit_len(4, obj_id.encode()) + emit_varint(5, difficulty)
            + emit_varint(6, tracking_difficulty)
            + emit_varint(7, num_points))


def encode_frame(context_name: str, timestamp_micros: int, pose: np.ndarray,
                 laser_calibrations: List[bytes], lasers: List[bytes],
                 labels: List[bytes]) -> bytes:
    ctx = emit_len(1, context_name.encode()) + b"".join(
        emit_len(3, c) for c in laser_calibrations)
    out = emit_len(1, ctx) + emit_varint(2, timestamp_micros)
    out += emit_len(3, encode_transform(pose))
    out += b"".join(emit_len(5, l) for l in lasers)
    out += b"".join(emit_len(6, l) for l in labels)
    return out
