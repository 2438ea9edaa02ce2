"""The native (C++) host code of the robot I/O, loaded with ctypes.

Counterpart of ``slamrs_tpu/native/``: ``neato_parser.cpp`` (the Neato
stream and frame parser, bulk log replay) and ``wire_codec.cpp`` (the
robot link's bincode data plane) are copies of the JAX package's
sources.  They are host code, not device kernels.

At first use (never at import) :func:`build` compiles them with ``g++``
into one shared library under ``build/slamrs_tpu_torch/native/`` beside
the package; nothing is written into the source tree.  The library is
rebuilt when a source is newer.  Where it does not build, the python
paths of ``io/neato.py`` and ``io/connection.py`` give the same results,
as in the JAX package, but not silently: :data:`build_error` holds why
the build failed and a warning is logged.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "neato_parser.cpp", _DIR / "wire_codec.cpp")
BUILD_DIR = _DIR.parents[1] / "build" / "slamrs_tpu_torch" / "native"
LIB = BUILD_DIR / "libslamrs_native.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# why the library did not build or load (None: it did, or was not tried)
build_error: Optional[str] = None

_LOCK = threading.Lock()
_LOADED: dict = {}


def build(force: bool = False) -> Path:
    """Compile :data:`SOURCES` into :data:`LIB` unless it is up to date."""
    newest = max(s.stat().st_mtime for s in SOURCES)
    if not force and LIB.exists() and LIB.stat().st_mtime >= newest:
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               *map(str, SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, LIB)  # atomic: a loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return LIB


def _facade(name: str, cls):
    """The loaded facade ``cls`` (built on first call), or None when the
    library does not build; thread-safe (a link's reader thread may be
    the first caller)."""
    global build_error
    with _LOCK:
        if name not in _LOADED:
            try:
                _LOADED[name] = cls(ctypes.CDLL(str(build())))
            except Exception as e:  # no g++, a failed build or load
                build_error = f"{type(e).__name__}: {e}"
                logging.getLogger(__name__).warning(
                    "native robot I/O library unavailable, using the python "
                    "paths: %s", build_error)
                _LOADED[name] = None
        return _LOADED[name]


def neato_native() -> Optional["NeatoNative"]:
    """The native Neato parser, or None (see :data:`build_error`)."""
    return _facade("neato", NeatoNative)


def wire_native() -> Optional["WireNative"]:
    """The native wire codec, or None (see :data:`build_error`)."""
    return _facade("wire", WireNative)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NeatoNative:
    """ctypes facade matching ``slamrs_tpu_torch.io.neato``'s python API."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.neato_parse_packets.restype = ctypes.c_long
        lib.neato_parse_packets.argtypes = [u8p, ctypes.c_long, u16p, u16p,
                                            u8p, ctypes.c_long]
        lib.neato_parse_frame.restype = None
        lib.neato_parse_frame.argtypes = [u8p, u16p, u16p, u8p]
        lib.neato_checksum_valid.restype = ctypes.c_int
        lib.neato_checksum_valid.argtypes = [u8p]

    def parse_packets(self, data: bytes):
        from slamrs_tpu_torch.io.neato import BEAMS, NeatoFrame

        buf = np.frombuffer(data, np.uint8)
        u8 = ctypes.c_uint8
        n = self._lib.neato_parse_packets(_ptr(buf, u8), len(buf), None,
                                          None, None, 0)
        if n <= 0:
            return []
        dist = np.zeros((n, BEAMS), np.uint16)
        stren = np.zeros((n, BEAMS), np.uint16)
        val = np.zeros((n, BEAMS), np.uint8)
        u16 = ctypes.c_uint16
        got = self._lib.neato_parse_packets(
            _ptr(buf, u8), len(buf), _ptr(dist, u16), _ptr(stren, u16),
            _ptr(val, u8), n)
        if got != n:
            raise RuntimeError(f"native parser wrote {got} of {n} frames")
        return [NeatoFrame(dist[i], stren[i], val[i]) for i in range(n)]

    def parse_frame(self, data: bytes):
        from slamrs_tpu_torch.io.neato import BEAMS, FRAME_BYTES, NeatoFrame

        buf = np.frombuffer(data, np.uint8)
        if buf.size != FRAME_BYTES:
            raise ValueError(f"frame must be {FRAME_BYTES} bytes")
        dist = np.zeros(BEAMS, np.uint16)
        stren = np.zeros(BEAMS, np.uint16)
        val = np.zeros(BEAMS, np.uint8)
        u8, u16 = ctypes.c_uint8, ctypes.c_uint16
        self._lib.neato_parse_frame(_ptr(buf, u8), _ptr(dist, u16),
                                    _ptr(stren, u16), _ptr(val, u8))
        return NeatoFrame(dist, stren, val)


class WireNative:
    """ctypes facade over the native bincode wire codec."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.wire_decode_scan_frames.restype = ctypes.c_long
        lib.wire_decode_scan_frames.argtypes = [
            u8p, ctypes.c_long, u8p, f32p, u16p, ctypes.c_long, lp]
        lib.wire_encode_command.restype = ctypes.c_long
        lib.wire_encode_command.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, u8p]

    def decode_scan_frames(self, data: bytes, max_frames: int = 64):
        """Returns ``([(scan_bytes, (ol, or), rpm), ...], consumed)``.
        The output buffers are fresh each call, so concurrent readers
        share nothing."""
        buf = np.frombuffer(data, np.uint8)
        scans = np.zeros((max_frames, 1980), np.uint8)
        odo = np.zeros((max_frames, 2), np.float32)
        rpm = np.zeros(max_frames, np.uint16)
        consumed = ctypes.c_long(0)
        n = self._lib.wire_decode_scan_frames(
            _ptr(buf, ctypes.c_uint8), len(buf), _ptr(scans, ctypes.c_uint8),
            _ptr(odo, ctypes.c_float), _ptr(rpm, ctypes.c_uint16),
            max_frames, ctypes.byref(consumed))
        out = [(scans[i].tobytes(), (float(odo[i, 0]), float(odo[i, 1])),
                int(rpm[i])) for i in range(n)]
        return out, int(consumed.value)

    def encode_command(self, kind: int, every: int = 0, left: float = 0.0,
                       right: float = 0.0, kp: float = 0.0,
                       ki: float = 0.0) -> bytes:
        out = (ctypes.c_uint8 * 16)()
        n = self._lib.wire_encode_command(kind, every, left, right, kp, ki,
                                          out)
        return bytes(out[:n])
