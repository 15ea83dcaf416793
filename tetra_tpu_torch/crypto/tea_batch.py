"""TEA1 keystreams of many slots in one C++ call (csrc/host/tea1_batch.cpp):
the fleet receiver's voice monitor makes a superblock's keystreams at
once, spread over worker threads, each row equal to crypto/tea.tea1's.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import host_library
from .tea_tables import TEA1_LUTA, TEA1_LUTB, TEA1_SBOX

_lib = None
_lock = threading.Lock()


def _load():
    """Build (on first use) and load the TEA1 batch library, its tables
    set from this module's constants."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "csrc", "host", "tea1_batch.cpp")
        lib = ctypes.CDLL(host_library("tetra_tea1", [src],
                                       ["-O2", "-std=c++17", "-pthread"]))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tea1_init.argtypes = [vp, vp, vp]
        lib.tea1_batch.argtypes = [vp, vp, vp, i64, i64, vp, i64]
        sbox = np.frombuffer(TEA1_SBOX, np.uint8).copy()
        lut_a = np.asarray(TEA1_LUTA, np.uint16)
        lut_b = np.asarray(TEA1_LUTB, np.uint16)
        lib.tea1_init(sbox.ctypes.data, lut_a.ctypes.data, lut_b.ctypes.data)
        _lib = lib
        return lib


def tea1_batch(iv32: np.ndarray, key_of: np.ndarray, keys: np.ndarray,
               n_bytes: int, threads: int = 1) -> np.ndarray:
    """TEA1 keystreams of many IVs in one call: (len(iv32), n_bytes) uint8,
    row i the keystream of iv32[i] under the 80-bit key keys[key_of[i]]
    (keys: (K, 10) uint8), equal to tea.tea1(iv32[i], key, n_bytes); the rows
    are spread over `threads` worker threads."""
    lib = _load()
    iv = np.ascontiguousarray(iv32, np.uint32)
    ko = np.ascontiguousarray(key_of, np.int64)
    k = np.ascontiguousarray(keys, np.uint8).reshape(-1, 10)
    if len(ko) and (ko.min() < 0 or ko.max() >= len(k)):
        raise ValueError("key_of indexes past the keys")
    out = np.empty((len(iv), n_bytes), np.uint8)
    if len(iv):
        lib.tea1_batch(iv.ctypes.data, ko.ctypes.data, k.ctypes.data,
                       len(iv), n_bytes, out.ctypes.data, threads)
    return out
