"""Host C++ geometry of the data pipeline — port of
findnpropagate_tpu/native/__init__.py.

Exact rotated-rectangle IoU (BEV and 3D), points-in-boxes and greedy
rotated NMS from ``geometry.cc`` (the port's own copy of the source),
compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/native/libfnp_geometry_<source hash>.so`` at the root of the
checkout and bound with ctypes. Nothing is built at import time.

There is no fallback: where the library cannot be built or loaded, every
call raises (utils/geometry_np.py keeps the numpy polygon clip as the plain
version for the tests, not as a substitute).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "geometry.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++14"]

_lock = threading.Lock()
_lib = None


def library_path():
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfnp_geometry_{digest}.so"


def _build(path):
    """Compile to a temporary name and rename, so that processes building
    at once never load a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SRC.name} with {CXX} failed: {e}"
                           ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} with {CXX} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def load():
    """The loaded library, built first where it is missing; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        ip32 = ctypes.POINTER(ctypes.c_int32)
        ip64 = ctypes.POINTER(ctypes.c_int64)
        lib.rotated_iou_bev.argtypes = [fp, i64, fp, i64, fp]
        lib.iou3d.argtypes = [fp, i64, fp, i64, fp]
        lib.iou_bev7.argtypes = [fp, i64, fp, i64, fp]
        lib.points_in_boxes.argtypes = [fp, i64, fp, i64, ip32]
        lib.nms_bev7.argtypes = [fp, ip64, i64, ctypes.c_float, ip64]
        lib.nms_bev7.restype = i64
        _lib = lib
        return _lib


def _f32c(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _pairwise(fn_name, boxes_a, boxes_b):
    lib = load()
    a, b = _f32c(boxes_a), _f32c(boxes_b)
    n, m = len(a), len(b)
    out = np.zeros((n, m), np.float32)
    if n and m:
        getattr(lib, fn_name)(_fp(a), n, _fp(b), m, _fp(out))
    return out


def rotated_iou_bev(boxes_a, boxes_b):
    """(N, 5) x (M, 5) [cx, cy, dx, dy, yaw] -> exact rotated IoU (N, M)."""
    return _pairwise("rotated_iou_bev", boxes_a, boxes_b)


def iou_bev7(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> exact rotated BEV IoU (height-agnostic)."""
    return _pairwise("iou_bev7", boxes_a, boxes_b)


def iou3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> exact rotated 3D IoU."""
    return _pairwise("iou3d", boxes_a, boxes_b)


def points_in_boxes(points, boxes):
    """(P, 3), (N, 7) -> (P,) int32 first-containing-box index (or -1)."""
    lib = load()
    p = _f32c(points[:, :3])
    b = _f32c(boxes[:, :7])
    out = np.full((len(p),), -1, np.int32)
    if len(p) and len(b):
        lib.points_in_boxes(
            _fp(p), len(p), _fp(b), len(b),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def nms_bev(boxes, scores, thresh):
    """(N, 7), (N,) -> kept indices (descending-score greedy rotated NMS)."""
    lib = load()
    b = _f32c(boxes[:, :7])
    order = np.argsort(-np.asarray(scores)).astype(np.int64)
    keep = np.zeros((len(b),), np.int64)
    if not len(b):
        return keep[:0]
    kept = lib.nms_bev7(
        _fp(b), order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(b), float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:kept]
