"""Python binding for the native ACELP speech codec (port of
tetra_tpu/voice/acelp.py).

The speech synthesis is scalar recursive filtering at 8 kHz - negligible
compute with the wrong shape for a GPU - so it stays in C++ behind a ctypes
C ABI, mirroring the reference's use of the native ETSI decoder
(tetra_lower_mac.c:355-363).  The source is the port's own copy,
csrc/host/acelp_codec.cpp (byte-equal to the JAX package's), built on first
use by ops._build.host_library into tetra_tpu_torch/build/ with the JAX
package's compiler flags (g++ -O2 -shared -fPIC, and -pthread), so both
builds compute the same floats.  The library is built from
csrc/host/acelp_batch.cpp, which includes the codec whole and adds
AcelpBank's batch entry point: the decoders of many calls synthesised in
one call, over worker threads.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import host_library

_HOST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host")
_SRC = os.path.join(_HOST, "acelp_codec.cpp")
_SRC_BATCH = os.path.join(_HOST, "acelp_batch.cpp")

_lib = None
_lock = threading.Lock()
# the tables load_codec_tables last loaded into the codec (None: its
# parametric quantizers), and a count of loads and clears; the card's
# synthesis (ops/acelp_kernel) reads both
_tables = None
_tables_version = 0

FRAME_BITS = 137
FRAME_SAMPLES = 240
SAMPLE_RATE = 8000

#: 137-bit speech frame layout, serialized in the order the reference codec's
#: Bits2prm_Tetra consumes parameters (tetra_lower_mac.c:355-363), with the
#: published TETRA bit allocation: LSP 26 bits as three split-VQ indices
#: (8+9+9), then per 60-sample subframe [pitch lag (8 absolute / 5 delta),
#: 16-bit algebraic codebook word, 6-bit gain field].  Per-field sourcing
#: confidence is recorded in PARITY.md (the ETSI quantizer codebook CONTENTS
#: are not publicly redistributable; widths/order are the sourced part).
FRAME_LAYOUT = (
    ("lsp1", 0, 8), ("lsp2", 8, 9), ("lsp3", 17, 9),
    ("pitch1", 26, 8), ("code1", 34, 16), ("gain1", 50, 6),
    ("pitch2", 56, 5), ("code2", 61, 16), ("gain2", 77, 6),
    ("pitch3", 83, 5), ("code3", 88, 16), ("gain3", 104, 6),
    ("pitch4", 110, 5), ("code4", 115, 16), ("gain4", 131, 6),
)
assert FRAME_LAYOUT[-1][1] + FRAME_LAYOUT[-1][2] == FRAME_BITS


def frame_field(name: str) -> tuple[int, int]:
    """(offset, width) of a FRAME_LAYOUT field."""
    for n, off, w in FRAME_LAYOUT:
        if n == name:
            return off, w
    raise KeyError(name)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(host_library("tetra_acelp", [_SRC_BATCH, _SRC],
                                       ["-O2", "-pthread"]))
        lib.tetra_acelp_create.restype = ctypes.c_void_p
        lib.tetra_acelp_destroy.argtypes = [ctypes.c_void_p]
        lib.tetra_acelp_decode_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16)]
        lib.tetra_acelp_enc_create.restype = ctypes.c_void_p
        lib.tetra_acelp_enc_destroy.argtypes = [ctypes.c_void_p]
        lib.tetra_acelp_encode_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.tetra_acelp_load_tables.restype = ctypes.c_int
        lib.tetra_acelp_load_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float]
        lib.tetra_acelp_tables_loaded.restype = ctypes.c_int
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tetra_acelp_decode_batch.argtypes = [vp, i64, vp, vp, vp, vp, vp,
                                                 vp, i64]
        _lib = lib
        return lib


def load_codec_tables(path: str) -> None:
    """Load runtime quantizer tables into the native codec (VERDICT r2 item
    5a: the real ETSI codebooks -- not redistributable, absent offline --
    drop in with zero code change).  `path` is an .npz with:

      lsf_cb1 (n1<=256, 3), lsf_cb2 (n2<=512, 3), lsf_cb3 (n3<=512, 4)
          float32 LSF split-VQ codevectors (the published 8+9+9-bit TETRA
          allocation over coefficient groups 0-2 / 3-5 / 6-9);
      gain_cb (ng<=64, 2) float32 rows of (pitch gain, code gain) for the
          6-bit joint gain field;
      lsf_pred () optional scalar: one-tap prediction coefficient applied
          to the previous reconstructed LSFs (0 = absolute VQ).

    Both the decoder and the encoder (nearest-codevector search) switch to
    the tables; frames interoperate only with the same-table peer."""
    lib = _load()
    z = np.load(path)
    cb1 = np.ascontiguousarray(z["lsf_cb1"], np.float32)
    cb2 = np.ascontiguousarray(z["lsf_cb2"], np.float32)
    cb3 = np.ascontiguousarray(z["lsf_cb3"], np.float32)
    gcb = np.ascontiguousarray(z["gain_cb"], np.float32)
    assert cb1.shape[1:] == (3,) and cb2.shape[1:] == (3,) \
        and cb3.shape[1:] == (4,) and gcb.shape[1:] == (2,), \
        (cb1.shape, cb2.shape, cb3.shape, gcb.shape)
    pred = float(z["lsf_pred"]) if "lsf_pred" in z.files else 0.0
    rc = lib.tetra_acelp_load_tables(
        cb1.ctypes.data, len(cb1), cb2.ctypes.data, len(cb2),
        cb3.ctypes.data, len(cb3), gcb.ctypes.data, len(gcb),
        ctypes.c_float(pred))
    if rc != 0:
        raise ValueError(f"codec table shapes rejected (rc={rc})")
    _set_tables((cb1, cb2, cb3, gcb, np.float32(pred)))


def clear_codec_tables() -> None:
    """Revert the native codec to its built-in parametric quantizers."""
    _load().tetra_acelp_clear_tables()
    _set_tables(None)


def _set_tables(tables) -> None:
    global _tables, _tables_version
    with _lock:
        _tables = tables
        _tables_version += 1


def codec_tables():
    """(version, tables): the count of loads and clears so far, and the
    tables the codec holds, (cb1, cb2, cb3, gain_cb, lsf_pred) as
    load_codec_tables loaded them, or None for its parametric
    quantizers."""
    with _lock:
        return _tables_version, _tables


class AcelpDecoder:
    """Stateful speech decoder: 137-bit frames -> 240 samples @ 8 kHz s16.

    Equivalent role to Init_Decod_Tetra + Bits2prm_Tetra + Decod_Tetra +
    Post_Process in the reference voice path.
    """

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.tetra_acelp_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tetra_acelp_destroy(self._h)
            self._h = None

    def decode_frame(self, bits: np.ndarray, bfi: bool = False) -> np.ndarray:
        bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
        assert bits.shape == (FRAME_BITS,)
        out = np.empty(FRAME_SAMPLES, np.int16)
        self._lib.tetra_acelp_decode_frame(
            self._h, bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(bfi), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out

    def decode_slot(self, frames: np.ndarray, bfi: bool = False) -> np.ndarray:
        """Two frames (2, 137) -> 480 samples (one traffic timeslot's voice,
        matching put_voice_data's 480-sample delivery, osmotetra_dec.h:216)."""
        frames = np.asarray(frames, np.uint8).reshape(2, FRAME_BITS)
        return np.concatenate([self.decode_frame(frames[0], bfi),
                               self.decode_frame(frames[1], bfi)])


def plan_calls(calls: np.ndarray):
    """(order, seg, keys) int64 of a batch whose item i belongs to call
    calls[i], items of a call in time order: the calls in ascending keys,
    call c's items order[seg[c]:seg[c + 1]] in their order."""
    calls = np.asarray(calls, np.int64)
    order = np.argsort(calls, kind="stable")
    ordered = calls[order]
    starts = np.flatnonzero(np.r_[True, ordered[1:] != ordered[:-1]]) \
        if len(calls) else np.zeros(0, np.int64)
    return order, np.append(starts, len(calls)), ordered[starts]


class AcelpBank:
    """The decoders of many calls, synthesised a batch at a time: one
    AcelpDecoder state per call key, made on the call's first synthesised
    item, and one C++ call a batch (acelp_batch.cpp) with the calls spread
    over `threads` worker threads, each call's items in order on one."""

    def __init__(self, threads: int = 1):
        self._lib = _load()
        self.threads = max(1, int(threads))
        self._handles: dict[int, int] = {}

    def __del__(self):
        lib = getattr(self, "_lib", None)
        for h in getattr(self, "_handles", {}).values():
            lib.tetra_acelp_destroy(h)
        self._handles = {}

    def __len__(self) -> int:
        return len(self._handles)

    def decode(self, calls: np.ndarray, frames: np.ndarray, bfi: np.ndarray,
               kind: np.ndarray) -> np.ndarray:
        """Items in time order within each call: calls (N,) int64 keys,
        frames (N, 2, 137) uint8 bits, bfi (N, 2) bad-frame flags, kind (N,)
        0 a full slot (both frames), 1 a surviving second half (240 samples
        of silence, then frame 2), 2 withheld (480 samples of silence; the
        call's decoder, if any, is left as it is).  Returns (N, 480) int16
        PCM."""
        calls = np.asarray(calls, np.int64)
        kind = np.ascontiguousarray(kind, np.int8)
        n = len(calls)
        out = np.empty((n, 2 * FRAME_SAMPLES), np.int16)
        if n == 0:
            return out
        order, seg, keys = plan_calls(calls)
        live = np.zeros(len(keys), bool)
        np.logical_or.at(live, np.searchsorted(keys, calls), kind != 2)
        handles = np.zeros(len(keys), np.uint64)
        for j, k in enumerate(keys.tolist()):
            h = self._handles.get(k)
            if h is None and live[j]:
                h = self._handles[k] = self._lib.tetra_acelp_create()
            handles[j] = h or 0
        frames = np.ascontiguousarray(frames, np.uint8)
        bfi = np.ascontiguousarray(bfi, np.uint8)
        assert frames.shape == (n, 2, FRAME_BITS) and bfi.shape == (n, 2)
        self._lib.tetra_acelp_decode_batch(
            handles.ctypes.data, len(keys), seg.ctypes.data,
            order.ctypes.data, frames.ctypes.data, bfi.ctypes.data,
            kind.ctypes.data, out.ctypes.data, self.threads)
        return out


class AcelpEncoder:
    """Stateful analysis-by-synthesis speech encoder: 240 samples @ 8 kHz s16
    -> 137-bit frames consumable by AcelpDecoder.

    Capability extension over the reference, which ships no speech encoder
    (its codec build compiles only the decode path, CMakeLists.txt:19-28);
    this closes the loop for TX-side voice in the cell simulator and for
    round-trip codec quality measurement.
    """

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.tetra_acelp_enc_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tetra_acelp_enc_destroy(self._h)
            self._h = None

    def encode_frame(self, pcm: np.ndarray) -> np.ndarray:
        pcm = np.ascontiguousarray(np.asarray(pcm, np.int16))
        assert pcm.shape == (FRAME_SAMPLES,)
        bits = np.empty(FRAME_BITS, np.uint8)
        self._lib.tetra_acelp_encode_frame(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return bits

    def encode_slot(self, pcm: np.ndarray) -> np.ndarray:
        """480 samples -> (2, 137) codec frames (one traffic timeslot)."""
        pcm = np.asarray(pcm, np.int16).reshape(2, FRAME_SAMPLES)
        return np.stack([self.encode_frame(pcm[0]), self.encode_frame(pcm[1])])
