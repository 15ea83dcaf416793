"""ctypes mirror of the native upper-MAC state (macparse.cpp's MacState).

A copy of the struct layout in tetra_tpu/rx/native_mac.py: the fleet
engine (rx/fleet.py) embeds one MacState per channel in its channel struct,
built from the port's own copy of the C++ source (csrc/host/macparse.cpp).
"""

from __future__ import annotations

import ctypes


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
