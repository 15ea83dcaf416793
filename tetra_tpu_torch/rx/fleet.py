"""Fleet receiver engine: the native multi-channel bit pipeline around the
batched FEC (port of tetra_tpu/rx/fleet.py).

Per cycle, Python makes two ctypes calls plus one FEC pass, independent of
the channel count:

    fleet_feed / fleet_feed_sb (C++)  demod symbols -> burst sync -> type-5 rows
    decode_rows_typed_packed (torch)  all rows' FEC on the engine's device
    fleet_dispatch (C++)              decoded rows -> per-channel MAC/display

The C++ engine is the reference's own source (tetra_tpu/rx/native/
fleet.cpp), compiled with g++ into this package's build directory; its
channel state struct is mirrored below.

Speech rows: a full-slot SCH/F row of a traffic slot (the channel's
ACCESS-ASSIGN says traffic when the dispatch reaches it) carries speech,
whose CRC fails by design, a failure the dispatch does not count.  Such
rows skip the FEC pass; the dispatch still sees them as voice slots.  With voice=True the engine's voice monitor
(voice/monitor.VoiceMonitor) decodes every voice row of a superblock,
full slots and surviving halves, after the dispatch.

Every batch, whatever its number of cells, takes the one FEC program
(rx/fec.decode_rows_typed_packed) over a keystream table of the batch's
scrambling codes; the link profile ("tunnel" or "pcie") sets only the
engine's worker threads.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from .. import spans as S
from ..ops._build import host_library
from . import fec as rx_fec
from .burst_sync import RX_UNLOCKED
from .display import DisplayState
from .native_mac import MacStateStruct
from .tdma import TdmaTime

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "host")
_SRC = os.path.join(_NATIVE, "fleet.cpp")
_SRC_DEP = os.path.join(_NATIVE, "macparse.cpp")

_lib = None
_lock = threading.Lock()

_T5P_BYTES, _T1P_BYTES, _META_COLS = 54, 34, 12

# display flag order (Disp.flags in fleet.cpp)
_DISP_FLAGS = ("advanced_link", "air_encryption", "sndcp_data",
               "circuit_data", "voice_service", "normal_mode",
               "migration_supported", "never_minimum_mode", "priority_cell",
               "dereg_mandatory", "reg_mandatory")


class _TTime(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in ("hn", "mn", "fn", "tn", "sn")]


class _Disp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int64) for n in
                 ("curr_hyperframe", "curr_multiframe", "curr_frame")]
                + [("timeslot_content", ctypes.c_int64 * 4)]
                + [(n, ctypes.c_int64) for n in
                   ("dl_usage", "ul_usage", "access1_code", "access2_code",
                    "access1", "access2", "dl_freq", "ul_freq", "mcc", "mnc",
                    "cc", "last_crc_fail")]
                + [("flags", ctypes.c_int64 * 11)])


class FleetChanStruct(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in
                ("state", "start_bitnum", "next_frame", "scan_from",
                 "lock_losses", "buf_len")] + [
        ("time", _TTime), ("slot_count", ctypes.c_int64),
        ("cell_mcc", ctypes.c_int64), ("cell_mnc", ctypes.c_int64),
        ("cell_cc", ctypes.c_int64), ("scramb_init", ctypes.c_int64),
        ("cell_time", _TTime),
        ("crc_oks", ctypes.c_int64), ("crc_fails", ctypes.c_int64),
        ("disp", _Disp), ("mac", MacStateStruct),
        ("ks_scramb", ctypes.c_int64), ("ks30", ctypes.c_uint8 * 30),
        ("buf", ctypes.c_uint8 * (1 << 16)),
    ]


def load():
    """Build (on first use, ops._build.host_library) and load the native
    fleet library; None when TETRA_NO_NATIVE_MAC is set (the fleet path is
    native only, so disabling the native MAC disables it too, as in the
    reference).  A failed build raises."""
    global _lib
    if os.environ.get("TETRA_NO_NATIVE_MAC"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(host_library(
            "tetra_fleet", [_SRC, _SRC_DEP],
            ["-O2", "-std=c++17", "-pthread", "-I", _NATIVE]))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fleet_create.restype = vp
        lib.fleet_create.argtypes = [i64, vp, i64, vp, i64, vp, i64, i64]
        lib.fleet_destroy.argtypes = [vp]
        lib.fleet_chan_size.restype = i64
        lib.fleet_chan_ptr.restype = vp
        lib.fleet_chan_ptr.argtypes = [vp, i64]
        lib.fleet_scramb_ptr.restype = vp
        lib.fleet_scramb_ptr.argtypes = [vp]
        lib.fleet_feed.restype = i64
        lib.fleet_feed.argtypes = [vp, vp, i64, vp, vp, i64]
        lib.fleet_feed_sb.restype = i64
        lib.fleet_feed_sb.argtypes = [vp, vp, i64, i64, vp, vp, i64]
        lib.fleet_dispatch.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp, vp]
        lib.fleet_set_rm.argtypes = [vp, vp, ctypes.c_uint64]
        lib.fleet_rm_redecode.argtypes = [vp, vp, vp, i64, vp]
        lib.fleet_set_threads.argtypes = [vp, i64]
        if lib.fleet_chan_size() != ctypes.sizeof(FleetChanStruct):
            raise RuntimeError(
                f"fleet channel struct mismatch: native "
                f"{lib.fleet_chan_size()} vs {ctypes.sizeof(FleetChanStruct)}")
        _lib = lib
        return lib


class FleetEngine:
    """Owns the native per-channel state for `channels` channels; the FEC
    runs on `device` (the current CUDA device unless the caller asks for
    the CPU)."""

    def __init__(self, channels: int, device=None, voice_cb=None,
                 threads: int | None = None, link_profile: str = "tunnel",
                 voice: bool = False, keystore: str | None = None):
        """The reference's signature, with device second (as the port's
        callers pass it), less its FEC program and bucket choices, and the
        voice monitor.

        voice: decode every call's speech (voice/monitor.VoiceMonitor,
        drained with take_voice()), decrypted with the text keystore at
        `keystore` where it holds the cell's key.

        threads: worker threads of the native per-channel loops (channels
        are independent; ctypes releases the GIL).  None reads
        TETRA_FLEET_THREADS; 0 picks by link_profile: "tunnel" cores-1
        (one core stays with the caller's device loop), "pcie" all cores;
        1 is sequential.  Results do not depend on it."""
        if link_profile not in ("tunnel", "pcie"):
            raise ValueError(f"link_profile={link_profile!r}: 'tunnel' or "
                             f"'pcie'")
        lib = load()
        if lib is None:
            raise RuntimeError("native fleet engine unavailable "
                               "(TETRA_NO_NATIVE_MAC is set)")
        self.lib = lib
        self.channels = channels
        self.device = resolve_device(device)
        self.voice_cb = voice_cb
        self.link_profile = link_profile
        if threads is None:
            threads = int(os.environ.get("TETRA_FLEET_THREADS", "0"))
        if threads == 0:
            cores = os.cpu_count() or 2
            threads = cores if link_profile == "pcie" else max(1, cores - 1)
        self.threads = threads
        y = np.ascontiguousarray(P.TRAIN_Y, np.uint8)
        n = np.ascontiguousarray(P.TRAIN_N, np.uint8)
        p = np.ascontiguousarray(P.TRAIN_P, np.uint8)
        self.h = lib.fleet_create(
            channels, y.ctypes.data, len(y), n.ctypes.data, len(n),
            p.ctypes.data, len(p), P.SCRAMB_INIT)
        # BBK rows decode natively at feed time (syndrome RM(30,14))
        parity = np.ascontiguousarray(P.RM3014_PARITY, np.uint8)
        tapmask = 0
        for t in P.SCRAMB_TAPS:
            tapmask |= 1 << (32 - t)
        lib.fleet_set_rm(self.h, parity.ctypes.data, tapmask)
        if threads != 1:
            lib.fleet_set_threads(self.h, threads)
        self.scramb = np.ctypeslib.as_array(
            ctypes.cast(lib.fleet_scramb_ptr(self.h),
                        ctypes.POINTER(ctypes.c_int64)), (channels,))
        self._chans = [FleetChanStruct.from_address(
            lib.fleet_chan_ptr(self.h, c)) for c in range(channels)]
        # every channel's burst-sync state (the struct's first field) in
        # one strided view over the native channel array
        size = lib.fleet_chan_size()
        chan_mem = (ctypes.c_char * (size * channels)).from_address(
            lib.fleet_chan_ptr(self.h, 0))

        def field(offset: int) -> np.ndarray:
            return np.ndarray((channels,), np.int64, strides=(size,),
                              buffer=chan_mem, offset=offset)
        self._sync_state = field(0)
        # the MAC's traffic flag (the last good ACCESS-ASSIGN's downlink
        # usage) and the adopted cell, every channel's in one view each
        self._is_traffic = field(FleetChanStruct.mac.offset)
        self.cell_mcc = field(FleetChanStruct.cell_mcc.offset)
        self.cell_mnc = field(FleetChanStruct.cell_mnc.offset)
        self.cell_cc = field(FleetChanStruct.cell_cc.offset)
        self._cap = 0
        self._t5 = self._meta = None
        # keystream table on the FEC device: row 0 = SCRAMB_INIT, then the
        # other codes of the last batch that brought a new one, ascending
        self._ks_codes = np.zeros(0, np.int64)
        self._ks_dev = None
        self.voice = None
        if voice:
            from ..voice.monitor import VoiceMonitor
            self.voice = VoiceMonitor(channels, self.device, keystore,
                                      threads)
        elif keystore is not None:
            raise ValueError("a keystore decrypts the voice monitor's "
                             "speech: pass voice=True with it")

    def __del__(self):
        h, self.h = getattr(self, "h", None), None
        if h:
            self.lib.fleet_destroy(h)

    # -- per-cycle pipeline ------------------------------------------------

    def process(self, dibits: np.ndarray, valid: np.ndarray) -> int:
        """One feed cycle from (C, T) dibit/valid arrays."""
        packed = ((np.asarray(dibits, np.uint8) & 3)
                  | (np.asarray(valid, np.uint8) << 7))
        return self.process_packed(packed)

    def _ks_rows(self, scrambs: np.ndarray) -> np.ndarray:
        """Each row's row of the keystream table, which is made and
        uploaded again only when the batch brings a code it lacks."""
        codes = np.unique(scrambs)
        codes = codes[codes != P.SCRAMB_INIT]
        if self._ks_dev is None or not np.isin(codes, self._ks_codes).all():
            self._ks_codes = codes
            self._ks_dev = torch.from_numpy(np.stack(
                [rx_fec.keystream(int(u), 432)
                 for u in (P.SCRAMB_INIT, *codes)])).to(self.device)
        return np.where(scrambs == P.SCRAMB_INIT, 0,
                        np.searchsorted(self._ks_codes, scrambs) + 1)

    def process_packed(self, packed: np.ndarray) -> int:
        """One feed cycle: (C, T) packed symbol bytes (bit 7 = valid, bits
        1:0 = dibit).  Returns the number of blocks decoded."""
        return self.process_packed_cycles(packed[None])

    def _ensure_rowbufs(self, K: int, T: int) -> None:
        # worst case: the whole per-channel ring backlog (1<<16 bits) drains
        # in one call on top of the fed bits
        cap = self.channels * (
            (K * T * 2 + (1 << 16)) // P.BITS_PER_TS + 2 * K) * 3
        if cap > self._cap:
            self._cap = cap
            self._t5 = np.empty((cap, _T5P_BYTES), np.uint8)
            self._meta = np.empty((cap, _META_COLS), np.int64)

    def process_packed_cycles(self, packed_k: np.ndarray) -> int:
        """K feed cycles of (K, C, T) packed bytes, then one FEC pass and one
        MAC dispatch over all emitted rows."""
        K, C, T = packed_k.shape
        if C != self.channels:
            raise ValueError(f"{C} channels fed to a {self.channels}-channel "
                             f"engine")
        self._ensure_rowbufs(K, T)
        n = 0
        for j in range(K):
            pj = np.ascontiguousarray(packed_k[j], np.uint8)
            n += self.lib.fleet_feed(
                self.h, pj.ctypes.data, T,
                self._t5[n:].ctypes.data, self._meta[n:].ctypes.data,
                self._cap - n)
            self._check_rows(n)
        return self._decode_dispatch(n, K)

    def process_packed2(self, words: np.ndarray, K: int,
                        n_chunks: int) -> int:
        """K feed cycles from the superblock's time-major words (the
        rx/receiver.pack_cycle_tc layout, (K*G, C) int32): per cycle
        2*n_chunks symbol rows then ceil(n_chunks/4) valid-count rows."""
        R, C = words.shape
        sym_words = n_chunks * 2
        cnt_words = -(-n_chunks // 4)
        if C != self.channels or R != K * (sym_words + cnt_words):
            raise ValueError(f"words {words.shape} do not match {K} cycles "
                             f"of {n_chunks} chunks x {self.channels}")
        with S.span("engine"):
            self._ensure_rowbufs(K, sym_words * 16)
            words = np.ascontiguousarray(words, np.int32)
            with S.span("engine.feed"):
                n = int(self.lib.fleet_feed_sb(
                    self.h, words.ctypes.data, K, n_chunks,
                    self._t5.ctypes.data, self._meta.ctypes.data, self._cap))
            self._check_rows(n)
            return self._decode_dispatch(n, K)

    def _check_rows(self, n: int) -> None:
        """The native feed signals a full row buffer by returning more rows
        than it holds (fleet.cpp emit_block); raise before those rows are
        read or the next feed is given a negative capacity."""
        if n > self._cap:
            raise RuntimeError(f"fleet_feed capacity overflow: {n} rows for "
                               f"a buffer of {self._cap}")

    def _decode(self, rows_t5p, rows_types, rows_scrambs):
        """One FEC pass over rows (rx/fec.decode_rows_typed_packed)."""
        idx = self._ks_rows(rows_scrambs)
        # the FEC pass (the keystream table above is the engine's own time)
        with S.span("fec"):
            S.count("fec.rows", len(rows_types))
            return rx_fec.decode_rows_typed_packed(rows_t5p, rows_types, idx,
                                                   self._ks_dev)

    def _speech_rows(self, meta: np.ndarray, chans: np.ndarray,
                     blk_types: np.ndarray) -> np.ndarray:
        """(n,) bool: the full-slot SCH/F rows that the dispatch will take
        as voice slots.  The MAC's traffic flag is set by each good
        ACCESS-ASSIGN (decoded at feed time, meta[:, 11]): traffic where
        its header is not 0 and its downlink usage is above 3, never in
        frame 18; a channel's rows before its batch's first good one take
        the flag the channel holds now.  The frame is the row's stamp,
        which is the dispatch's wherever no SYNC PDU moves the channel's
        time within the batch (_moved_channels)."""
        n = len(meta)
        sch = blk_types == P.TPSAP_T_SCH_F
        if not sch.any():
            return sch
        v = meta[:, 11]
        aach = (blk_types == P.TPSAP_T_BBK) & ((v & 0xC000) == 0xC000)
        traffic = ((v >> 12) & 3 != 0) & ((v >> 6) & 0x3F > 3) \
            & (meta[:, 5] != 18)
        i = np.arange(n)
        last = np.maximum.accumulate(np.where(aach, i, -1))
        first = np.maximum.accumulate(np.where(
            np.r_[True, chans[1:] != chans[:-1]], i, 0))
        own = last >= first
        flag = np.where(own, traffic[np.maximum(last, 0)],
                        self._is_traffic[chans] != 0)
        return sch & flag

    @staticmethod
    def _moved_channels(meta: np.ndarray, rows: np.ndarray,
                        type1p: np.ndarray) -> np.ndarray:
        """Channels of the good SYNC PDU rows `rows` whose timeslot or frame
        differs from the row's stamp: the dispatch moves those channels'
        time, and with it the frame their ACCESS-ASSIGNs are read in."""
        t1 = np.unpackbits(type1p[rows, :3], axis=1)
        tn = t1[:, 10:12] @ np.array([2, 1]) + 1
        fn = (t1[:, 12:17] @ (1 << np.arange(4, -1, -1)) - 1) % 18 + 1
        moved = (tn != meta[rows, 4]) | (fn != meta[rows, 5])
        return np.unique(meta[rows[moved], 0])

    def _decode_dispatch(self, n: int, K: int) -> int:
        """Emitted type-5 rows -> one FEC pass -> native MAC dispatch ->
        deferred voice callbacks and the voice monitor (the reference's
        flow, step for step, but for the speech rows' skipped FEC)."""
        if n == 0:
            return 0
        if K > 1:
            # channel-major row order, chronological within each channel
            order = np.argsort(self._meta[:n, 0], kind="stable")
            self._t5[:n] = self._t5[:n][order]
            self._meta[:n] = self._meta[:n][order]
        meta = self._meta[:n]
        t5p = self._t5[:n]
        chans = meta[:, 0]
        blk_types = meta[:, 1]
        scrambs = self.scramb[chans]

        # BBK rows were decoded at feed time: meta[11] = info14 | ok<<14 | 1<<15
        local = (meta[:, 11] & 0x8000) != 0
        speech = self._speech_rows(meta, chans, blk_types)

        def fill_local(rows, type1p, ok):
            vals = meta[rows, 11]
            info = (vals & 0x3FFF).astype(np.int64)
            type1p[rows] = 0
            type1p[rows, 0] = (info >> 6).astype(np.uint8)
            type1p[rows, 1] = ((info & 63) << 2).astype(np.uint8)
            ok[rows] = ((vals >> 14) & 1).astype(bool)

        if local.any() or speech.any():
            type1p = np.zeros((n, _T1P_BYTES), np.uint8)
            ok = np.zeros(n, bool)
            didx = np.nonzero(~local & ~speech)[0]
            if len(didx):
                t1d, okd = self._decode(t5p[didx], blk_types[didx],
                                        scrambs[didx])
                type1p[didx] = t1d
                ok[didx] = okd
            fill_local(np.nonzero(local)[0], type1p, ok)
        else:
            type1p, ok = self._decode(t5p, blk_types, scrambs)

        # adopt each channel's first good SYNC PDU scrambling code and
        # re-decode rows decoded under a stale code; the speech rows of a
        # channel whose time a SYNC PDU moves decode too (the frame that
        # made them speech may not be the dispatch's)
        sb1 = (blk_types == P.TPSAP_T_SB1) & ok
        redo = np.zeros(n, bool)
        if sb1.any():
            rows = np.nonzero(sb1)[0]
            t1s = np.unpackbits(type1p[rows], axis=1)
            mcc = t1s[:, 31:41] @ (1 << np.arange(9, -1, -1))
            mnc = t1s[:, 41:55] @ (1 << np.arange(13, -1, -1))
            cc = t1s[:, 4:10] @ (1 << np.arange(5, -1, -1))
            new_scr = ((cc | (mnc << 6) | (mcc << 20)) << 2) | P.SCRAMB_INIT
            adopted: dict[int, int] = {}
            for r, sc in zip(rows, new_scr):
                c = int(chans[r])
                if c not in adopted:
                    adopted[c] = int(sc)
            for c, sc in adopted.items():
                if sc != int(self.scramb[c]):
                    redo |= (chans == c) & (blk_types != P.TPSAP_T_SB1)
                    scrambs[chans == c] = sc
            if speech.any():
                redo |= speech & np.isin(
                    chans, self._moved_channels(meta, rows, type1p))
        if redo.any():
            bidx = np.nonzero(redo & local)[0]
            if len(bidx):
                tb = np.ascontiguousarray(t5p[bidx])
                sb = np.ascontiguousarray(scrambs[bidx], np.int64)
                out64 = np.empty(len(bidx), np.int64)
                self.lib.fleet_rm_redecode(self.h, tb.ctypes.data,
                                           sb.ctypes.data, len(bidx),
                                           out64.ctypes.data)
                meta[bidx, 11] = out64 | 0x8000
                fill_local(bidx, type1p, ok)
            ridx = np.nonzero(redo & ~local)[0]
            if len(ridx):
                t1r, okr = self._decode(t5p[ridx], blk_types[ridx],
                                        scrambs[ridx])
                type1p[ridx] = t1r
                ok[ridx] = okr

        actions = np.empty(n, np.uint8)
        times = np.empty((n, 5), np.int64)
        okb = np.ascontiguousarray(ok, np.uint8)
        type1p = np.ascontiguousarray(type1p)
        half_cb = getattr(self.voice_cb, "half", None)
        want = self.voice is not None
        with S.span("engine.dispatch"):
            self.lib.fleet_dispatch(self.h, type1p.ctypes.data,
                                    okb.ctypes.data, meta.ctypes.data, n,
                                    int(want or self.voice_cb is not None),
                                    int(want or half_cb is not None),
                                    actions.ctypes.data, times.ctypes.data)
        if self.voice_cb is not None and actions.any():
            for i in np.nonzero(actions)[0]:
                if actions[i] == 2 and half_cb is None:
                    continue
                c = int(chans[i])
                t345 = int(meta[i, 10])
                type5 = np.unpackbits(t5p[i])[:t345]
                type4 = type5 ^ rx_fec.keystream(int(self.scramb[c]), t345)
                t = TdmaTime(*(int(v) for v in times[i]))
                if actions[i] == 1:
                    self.voice_cb(t, type4)
                else:
                    half_cb(t, type4)
        if self.voice is not None:
            rows = np.nonzero(actions)[0]
            self.voice.process(self, rows,
                               (actions[rows] - 1).astype(np.int8), t5p,
                               meta, times, type1p, ok)
        return int(n)

    def take_voice(self) -> list:
        """The voice monitor's VoiceBlocks since the last call, one a
        superblock, oldest first (voice/monitor.VoiceMonitor.take)."""
        if self.voice is None:
            raise ValueError("the engine was built without voice=True")
        return self.voice.take()

    # -- checkpoint ----------------------------------------------------------

    def state_bytes(self) -> bytes:
        """Every channel's native state as raw struct bytes (fixed-width
        fields, no pointers: restores into any engine of this size, in
        either package)."""
        return b"".join(bytes(self._chans[c]) for c in range(self.channels))

    def load_state_bytes(self, data: bytes) -> None:
        sz = ctypes.sizeof(FleetChanStruct)
        if len(data) != sz * self.channels:
            raise ValueError(f"state blob of {len(data)} bytes is not "
                             f"{self.channels} x {sz}")
        for c in range(self.channels):
            ctypes.memmove(ctypes.addressof(self._chans[c]),
                           data[c * sz:(c + 1) * sz], sz)
            self.scramb[c] = self._chans[c].scramb_init

    # -- views ---------------------------------------------------------------

    def chan(self, c: int) -> FleetChanStruct:
        return self._chans[c]

    def display(self, c: int) -> DisplayState:
        d = self._chans[c].disp
        return DisplayState(
            curr_hyperframe=d.curr_hyperframe,
            curr_multiframe=d.curr_multiframe, curr_frame=d.curr_frame,
            timeslot_content=list(d.timeslot_content),
            dl_usage=d.dl_usage, ul_usage=d.ul_usage,
            access1_code=chr(d.access1_code) if d.access1_code else "",
            access2_code=chr(d.access2_code) if d.access2_code else "",
            access1=d.access1, access2=d.access2,
            dl_freq=d.dl_freq, ul_freq=d.ul_freq,
            mcc=d.mcc, mnc=d.mnc, cc=d.cc,
            last_crc_fail=bool(d.last_crc_fail),
            **{name: bool(d.flags[i]) for i, name in enumerate(_DISP_FLAGS)})

    def locked(self, c: int) -> bool:
        return self._chans[c].state == 2

    def unlocked(self) -> np.ndarray:
        """(C,) bool: the channels hunting for a burst (RX_UNLOCKED)."""
        return self._sync_state == RX_UNLOCKED

    def crc_counts(self, c: int) -> tuple[int, int]:
        ch = self._chans[c]
        return int(ch.crc_oks), int(ch.crc_fails)

    def phy_time(self, c: int) -> TdmaTime:
        t = self._chans[c].time
        return TdmaTime(t.hn, t.mn, t.fn, t.tn, t.sn)

    def lock_losses(self, c: int) -> int:
        return int(self._chans[c].lock_losses)
