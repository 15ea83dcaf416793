"""ctypes binding for the native upper-MAC receive core (port of
tetra_tpu/rx/native_mac.py).

The C++ core (the port's copy of the reference's source,
csrc/host/macparse.cpp) handles the no-event-log receive path, the
production bulk configuration; rx/upper_mac.py stays the full-featured
oracle, and the tests hold the two to the same state and display.  The
fleet engine (rx/fleet.py) embeds one MacState per channel in its channel
struct, mirrored below.

The library is built with g++ on first use (ops._build.host_library); a
failed build raises.  Set TETRA_NO_NATIVE_MAC=1 to run the Python loop
instead (the parity tests do).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import host_library

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "macparse.cpp")

_lib = None
_lock = threading.Lock()

# packed receive-result layout (macparse.cpp)
F_TRAFFIC = 0xFF
F_BLK1 = 1 << 8
F_BLK2 = 1 << 9
F_ADDR_SHIFT, F_ADDR_MASK = 10, 7
F_USAGE_SHIFT, F_USAGE_MASK = 13, 0x3F
F_AACH_SEEN = 1 << 20
F_SI_SEEN = 1 << 21
F_SSI_SHIFT, F_SSI_MASK = 32, 0xFFFFFF

# macparse_dispatch dout indices (enum in macparse.cpp)
(D_CRC_OK, D_CRC_FAIL, D_LAST_CRC_FAIL, D_SI_SEEN, D_HF_SEEN, D_HF_VAL,
 D_A_HAVE1, D_A_CODE1, D_A_VAL1, D_A_HAVE2, D_A_CODE2, D_A_VAL2,
 D_A_HAVE_DL, D_A_DL, D_A_HAVE_UL, D_A_UL,
 D_CONTENT0, D_CONTENT1, D_CONTENT2, D_CONTENT3,
 D_LAST_MN, D_LAST_FN,
 D_SB1_SEEN, D_MCC, D_MNC, D_CC,
 D_SB1_OK, D_CELL_MCC, D_CELL_MNC, D_CELL_CC,
 D_CELL_TN, D_CELL_FN, D_CELL_MN, D_CELL_SIDX,
 DOUT_LEN) = range(35)
META_FIELDS = 12  # off, nbits, blk_type, blk_num, crc_ok, slot_index,
                  # tn, fn, mn, hn, train_seq, sn


class AachStruct(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in
                ("have1", "code1", "val1", "have2", "code2", "val2",
                 "have_dl", "dl", "have_ul", "ul")]


SYSINFO_FIELDS = (
    "main_carrier", "freq_band", "freq_offset", "duplex_spacing",
    "reverse_operation", "num_of_csch", "ms_txpwr_max_cell",
    "rxlev_access_min", "access_parameter", "radio_dl_timeout",
    "cck_valid_no_hf", "cck_id", "hyperframe_number", "option_field",
    "frame_bitmap", "access_code", "ext_service", "la", "subscr_class",
    "bs_service_details")


class SysinfoStruct(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int64) for n in SYSINFO_FIELDS]
                + [("dl_freq", ctypes.c_int64), ("ul_freq", ctypes.c_int64)])


class _FragStruct(ctypes.Structure):
    _fields_ = [("active", ctypes.c_int64), ("age", ctypes.c_int64),
                ("num_frags", ctypes.c_int64), ("length", ctypes.c_int64),
                ("encryption", ctypes.c_int64), ("nbits", ctypes.c_int64),
                ("bits", ctypes.c_uint8 * 16384)]


class MacStateStruct(ctypes.Structure):
    _fields_ = [("is_traffic", ctypes.c_int64),
                ("blk1_stolen", ctypes.c_int64),
                ("blk2_stolen", ctypes.c_int64),
                ("ssi", ctypes.c_int64), ("usage_marker", ctypes.c_int64),
                ("addr_type", ctypes.c_int64),
                ("aach", AachStruct), ("si", SysinfoStruct),
                ("frags", _FragStruct * 5)]


def load():
    """The native MAC library, built on first use; None when
    TETRA_NO_NATIVE_MAC is set.  A failed build or a struct layout that
    differs from the mirror above raises."""
    global _lib
    if os.environ.get("TETRA_NO_NATIVE_MAC"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(host_library("tetra_macparse", [_SRC],
                                       ["-O2", "-std=c++17"]))
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.macparse_create.restype = vp
        lib.macparse_create.argtypes = []
        lib.macparse_destroy.restype = None
        lib.macparse_destroy.argtypes = [vp]
        lib.macparse_state.restype = vp
        lib.macparse_state.argtypes = [vp]
        lib.macparse_state_size.restype = i64
        lib.macparse_state_size.argtypes = []
        lib.macparse_receive.restype = u64
        lib.macparse_receive.argtypes = [vp, vp, i64, i64, i64, i64, u64]
        lib.macparse_dispatch.restype = u64
        lib.macparse_dispatch.argtypes = [vp, vp, vp, i64, u64, i64, i64,
                                          i64, i64, vp, vp, vp]
        if lib.macparse_state_size() != ctypes.sizeof(MacStateStruct):
            raise RuntimeError(
                f"MacState struct mismatch: native "
                f"{lib.macparse_state_size()} vs "
                f"{ctypes.sizeof(MacStateStruct)}")
        _lib = lib
        return lib


class NativeMacHandle:
    """Owns one C MacState; exposes the struct view for field sync."""

    __slots__ = ("lib", "h", "st")

    def __init__(self, lib):
        self.lib = lib
        self.h = lib.macparse_create()
        self.st = MacStateStruct.from_address(lib.macparse_state(self.h))

    def receive(self, bits_ptr, n, lchan, tn, fn, flags_in) -> int:
        return self.lib.macparse_receive(self.h, bits_ptr, n, lchan, tn, fn,
                                         flags_in)

    def dispatch(self, bits, meta, flags_in, have_voice, have_half,
                 base_hn, base_sn):
        """One call for a whole feed cycle's block list (macparse_dispatch).

        bits: concatenated type-1 bit buffer (uint8, C-contiguous);
        meta: (n, META_FIELDS) int64.  Returns (flags, dout, actions, times)
        -- dout int64[DOUT_LEN] accumulated display/cell deltas, actions
        uint8[n] deferred voice work, times int64[n,5] restamped TDMA times
        (hn,mn,fn,tn,sn)."""
        if bits.dtype != np.uint8 or not bits.flags["C_CONTIGUOUS"]:
            raise ValueError("bits must be C-contiguous uint8")
        if meta.dtype != np.int64 or meta.shape[1:] != (META_FIELDS,) \
                or not meta.flags["C_CONTIGUOUS"]:
            raise ValueError(f"meta must be C-contiguous (n, {META_FIELDS}) "
                             f"int64")
        n = len(meta)
        dout = np.zeros(DOUT_LEN, np.int64)
        actions = np.zeros(n, np.uint8)
        times = np.zeros((n, 5), np.int64)
        flags = self.lib.macparse_dispatch(
            self.h, bits.ctypes.data, meta.ctypes.data, n, flags_in,
            have_voice, have_half, base_hn, base_sn,
            dout.ctypes.data, actions.ctypes.data, times.ctypes.data)
        return flags, dout, actions, times

    def __del__(self):
        h, self.h = getattr(self, "h", None), None
        if h:
            self.lib.macparse_destroy(h)
