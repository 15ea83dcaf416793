"""Python binding for the native IQ stream runtime (port of
tetra_tpu/runtime/iq_stream.py).

Streaming input paths for the receiver: file playback (optionally paced to
real time) and live UDP, feeding fixed-size blocks to the pipeline through
a native ring buffer with overrun accounting.  The C++ source is the
port's own copy, csrc/host/iq_stream.cpp (held byte-equal to the JAX
package's by tests/test_torch_tables.py), built with the reference's g++
flags into tetra_tpu_torch/build/ on first use (ops/_build.host_library).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import CSRC, host_library

_SRC = os.path.join(CSRC, "host", "iq_stream.cpp")

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(host_library("tetra_iqstream", [_SRC],
                                       ["-O2", "-std=c++17"], ["-lpthread"]))
        lib.iqstream_create.restype = ctypes.c_void_p
        lib.iqstream_create.argtypes = [ctypes.c_uint64]
        lib.iqstream_feed_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_double]
        lib.iqstream_open_udp.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.iqstream_read.restype = ctypes.c_uint64
        lib.iqstream_read.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_uint64, ctypes.c_int]
        for fn in ("iqstream_total", "iqstream_overruns", "iqstream_level"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.iqstream_eof.argtypes = [ctypes.c_void_p]
        lib.iqstream_stop.argtypes = [ctypes.c_void_p]
        lib.iqstream_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class IqStream:
    """Single-channel complex64 sample stream backed by the native ring."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = _load()
        self._h = self._lib.iqstream_create(capacity)

    def feed_file(self, path: str, realtime_rate: float = 0.0):
        """Start the file reader thread; rate > 0 paces playback to rate
        samples/second (real-time simulation)."""
        rc = self._lib.iqstream_feed_file(self._h, path.encode(), realtime_rate)
        if rc != 0:
            raise OSError(f"feed_file failed: {rc}")

    def open_udp(self, port: int):
        rc = self._lib.iqstream_open_udp(self._h, port)
        if rc != 0:
            raise OSError(f"open_udp failed: {rc}")

    def read(self, n: int, timeout_ms: int = 1000) -> np.ndarray:
        """Blocking read of up to n samples; returns complex64 (may be short
        on timeout, empty when the stream is drained after EOF)."""
        out = np.empty(2 * n, np.float32)
        got = self._lib.iqstream_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, timeout_ms)
        pairs = out[:2 * got].reshape(-1, 2)
        return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)

    @property
    def total(self) -> int:
        return self._lib.iqstream_total(self._h)

    @property
    def overruns(self) -> int:
        return self._lib.iqstream_overruns(self._h)

    @property
    def level(self) -> int:
        return self._lib.iqstream_level(self._h)

    @property
    def eof(self) -> bool:
        return bool(self._lib.iqstream_eof(self._h))

    def stop(self):
        self._lib.iqstream_stop(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.iqstream_destroy(self._h)
            self._h = None
