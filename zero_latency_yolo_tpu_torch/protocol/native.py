"""ctypes binding to the native codec (native/codec.cpp, native/udp.cpp).

A copy of the JAX package's `protocol/native.py` over the port's own copies
of the C++ sources. The library is built at first use (the first read of
`HAVE_NATIVE`, `HAVE_FRAME_BUILDER` or `_LIB`, or the first codec call), not
at import, with the host's C++ compiler (`g++ -O3 -std=c++17 -fPIC
-shared`, or `$CXX`) into `build/native/` at the repo root, named by a hash
of the sources and flags, never into the source tree. Every entry point
degrades to the pure-Python codec when no compiler is found: the native
tier is a fast path, not a dependency. `HAVE_NATIVE` says which codec
serves.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("codec")

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SOURCES = ("codec.cpp", "udp.cpp")
_BUILD_DIR = _NATIVE_DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-Wall", "-std=c++17", "-fPIC", "-shared")


class _ZlHeader(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint8),
                ("length", ctypes.c_uint16),
                ("sequence", ctypes.c_uint32),
                ("timestamp", ctypes.c_uint64)]


class _ZlFrameHeader(ctypes.Structure):
    _fields_ = [("frame_id", ctypes.c_uint32),
                ("timestamp", ctypes.c_uint64),
                ("width", ctypes.c_uint16),
                ("height", ctypes.c_uint16),
                ("keyframe", ctypes.c_uint8),
                ("payload_offset", ctypes.c_uint32),
                ("payload_size", ctypes.c_uint32)]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in sorted(_SOURCES) + ["codec.h"]:
        h.update(name.encode())
        h.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_DIR / f"libzlcodec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into build/native/ (atomically) unless a library
    for these sources and flags is already there; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++, c++, $CXX)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(_NATIVE_DIR / n) for n in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native codec build failed: {proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None without a
    compiler."""
    try:
        path = build()
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("native codec unavailable (%s); using pure-Python codec",
                    e)
        return None
    lib.zl_crc16.restype = ctypes.c_uint16
    lib.zl_crc16.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.zl_validate_packet.restype = ctypes.c_int
    lib.zl_validate_packet.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_ZlHeader)]
    lib.zl_build_ack.restype = ctypes.c_int
    lib.zl_build_ack.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    lib.zl_build_heartbeat.restype = ctypes.c_int
    lib.zl_build_heartbeat.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    lib.zl_build_detection_result.restype = ctypes.c_int
    lib.zl_build_detection_result.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64]
    lib.zl_parse_frame_header.restype = ctypes.c_int
    lib.zl_parse_frame_header.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_ZlFrameHeader)]
    lib.zl_build_frame_data.restype = ctypes.c_int
    lib.zl_build_frame_data.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.c_uint16, ctypes.c_uint16, ctypes.c_uint8,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64]
    return lib


def __getattr__(name: str):
    # The JAX package's module constants, computed at first read. Built
    # from the port's own sources, the library always has the frame
    # builder, so HAVE_FRAME_BUILDER is HAVE_NATIVE.
    if name == "_LIB":
        return _lib()
    if name in ("HAVE_NATIVE", "HAVE_FRAME_BUILDER"):
        return _lib() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _require_lib():
    """Builders need the .so; raise a CLEAR error when it's absent instead
    of an AttributeError on None (callers that can fall back should gate on
    HAVE_NATIVE like the server does)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native codec unavailable (libzlcodec not "
                           "built); gate on native.HAVE_NATIVE")
    return lib


def crc16_native(data: bytes) -> int:
    return _require_lib().zl_crc16(data, len(data))


def validate_packet(data: bytes) -> Optional[Tuple[int, int, int, int]]:
    """Fast validity check. Returns (type, length, sequence, timestamp) or
    None if invalid. Falls back to None when native codec unavailable."""
    lib = _lib()
    if lib is None:
        return None
    hdr = _ZlHeader()
    if lib.zl_validate_packet(data, len(data), ctypes.byref(hdr)) != 0:
        return None
    return hdr.type, hdr.length, hdr.sequence, hdr.timestamp


def build_ack(acked_seq: int, seq: int, ts_ms: int) -> bytes:
    buf = ctypes.create_string_buffer(26)
    n = _require_lib().zl_build_ack(buf, acked_seq, seq, ts_ms)
    return buf.raw[:n]


def build_heartbeat(ping: int, seq: int, ts_ms: int) -> bytes:
    buf = ctypes.create_string_buffer(26)
    n = _require_lib().zl_build_heartbeat(buf, ping, seq, ts_ms)
    return buf.raw[:n]


def build_frame_data(frame_id: int, frame_ts: int, w: int, h: int,
                     keyframe: bool, payload: bytes, seq: int,
                     ts_ms: int) -> bytes:
    """FRAME_DATA with the CRC computed in C++ — the client-side hot path
    (a pure-Python CRC over every 60 FPS payload dominates client CPU)."""
    buf = ctypes.create_string_buffer(22 + 17 + len(payload))
    n = _require_lib().zl_build_frame_data(
        buf, frame_id, frame_ts, w, h, 1 if keyframe else 0,
        payload, len(payload), seq, ts_ms)
    if n < 0:
        raise ValueError("frame payload exceeds the u16 body length")
    return buf.raw[:n]


def build_detection_result(frame_id: int, frame_ts: int,
                           dets: np.ndarray, track_ids: np.ndarray,
                           det_ts: int, seq: int, ts_ms: int) -> bytes:
    """dets: (n, 6) f32 [x, y, w, h, conf, class]; track_ids: (n,) u32."""
    n = len(dets)
    buf = ctypes.create_string_buffer(22 + 14 + 40 * max(n, 1))
    dets = np.ascontiguousarray(dets, np.float32)
    tids = np.ascontiguousarray(track_ids, np.uint32)
    size = _require_lib().zl_build_detection_result(
        buf, frame_id, frame_ts,
        dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        det_ts, n, seq, ts_ms)
    if size < 0:
        raise ValueError("too many detections")
    return buf.raw[:size]


def parse_frame_header(data: bytes):
    """Returns (frame_id, timestamp, width, height, keyframe, payload_offset)
    or None."""
    lib = _lib()
    if lib is None:
        return None
    out = _ZlFrameHeader()
    if lib.zl_parse_frame_header(data, len(data), ctypes.byref(out)) != 0:
        return None
    return (out.frame_id, out.timestamp, out.width, out.height,
            bool(out.keyframe), out.payload_offset)
