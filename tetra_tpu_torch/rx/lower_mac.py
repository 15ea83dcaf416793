"""Lower MAC: bursts -> batched device FEC -> upper MAC dispatch (port of
tetra_tpu/rx/lower_mac.py; the FEC runs on each LowerMac's torch device).

Re-design of tetra_lower_mac.c:148-412 for batch processing: instead of
descramble/deinterleave/depuncture/viterbi/CRC per block in a scalar loop,
every block of a burst batch decodes in one fused pass
(rx.fec.decode_blocks_mixed), then results dispatch sequentially through
the host upper MAC so ordering-sensitive state (AACH traffic flags before SCH/F voice,
SYNC PDU scrambling-code updates) behaves exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .. import params as P
from .. import resolve_device
from . import fec as rx_fec
from .burst_sync import Burst
from .mac_pdu import bits_to_uint
from .tdma import PhyState, TdmaTime, is_bnch
from .upper_mac import (LC_AACH, LC_BNCH, LC_BSCH, LC_SCH_F, LC_UNKNOWN,
                        UpperMac)


@dataclass
class CellData:
    """Mirror of struct tetra_cell_data (tetra_lower_mac.c:107-116)."""
    mcc: int = 0
    mnc: int = 0
    colour_code: int = 0
    scramb_init: int = P.SCRAMB_INIT
    time: TdmaTime = field(default_factory=TdmaTime)


@dataclass
class LowerMac:
    upper: UpperMac = field(default_factory=UpperMac)
    cell: CellData = field(default_factory=CellData)
    phy: PhyState = field(default_factory=PhyState)
    # voice callback: (time, type4_bits (432,)) -> None, called for traffic
    # SCH/F slots (the reference routes these to the ACELP codec,
    # tetra_lower_mac.c:287-372)
    voice_cb: Callable | None = None
    crc_fails: int = 0
    crc_oks: int = 0
    # the FEC's torch device: the current CUDA device unless the caller
    # asks for the CPU
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _dispatch(self, blk_type: int, blk_num: int, type1: np.ndarray,
                  crc_ok: bool, time: TdmaTime, type4: np.ndarray | None,
                  slot_index: int = 0):
        d = self.upper.display
        is_voice_slot = (blk_type == P.TPSAP_T_SCH_F
                         and bool(self.upper.is_traffic))
        if crc_ok:
            self.crc_oks += 1
        elif not is_voice_slot:
            # traffic SCH/F carries speech bits, not a CRC-protected control
            # block; the reference likewise ignores its CRC
            # (tetra_lower_mac.c:228)
            self.crc_fails += 1
        lchan = LC_UNKNOWN
        if blk_type == P.TPSAP_T_SB1:
            # SYNC PDU: parsed inline like tetra_lower_mac.c:246-276
            d.mcc = bits_to_uint(type1, 31, 10)
            d.mnc = bits_to_uint(type1, 41, 14)
            d.cc = bits_to_uint(type1, 4, 6)
            if crc_ok:
                c = self.cell
                c.colour_code = bits_to_uint(type1, 4, 6)
                c.time.tn = bits_to_uint(type1, 10, 2) + 1
                # normalize the OTA 5/6-bit fields into their valid ranges
                # (fn 1..18, mn 1..60): a noise-corrupted CRC-passing SYNC
                # could otherwise store denormalized values on which the
                # add_tn twins (Python floor-mod vs C++) disagree;
                # norm_field in macparse.cpp is the native twin
                c.time.fn = (bits_to_uint(type1, 12, 5) - 1) % 18 + 1
                c.time.mn = (bits_to_uint(type1, 17, 6) - 1) % 60 + 1
                c.mcc = bits_to_uint(type1, 31, 10)
                c.mnc = bits_to_uint(type1, 41, 14)
                c.scramb_init = P.scramb_get_init(c.mcc, c.mnc, c.colour_code)
                # SYNC PDU re-synchronizes the shared PHY time
                # (tetra_lower_mac.c:277-279), advanced by the number of
                # slots the synchronizer already stamped past this burst
                # (batch-processing lag; see PhyState.slot_count)
                lag = self.phy.slot_count - slot_index
                self.phy.time.tn = c.time.tn
                self.phy.time.fn = c.time.fn
                self.phy.time.mn = c.time.mn
                if lag > 0:
                    self.phy.time.add_tn_bulk(lag)
                self._resync_base = (c.time.copy(), slot_index)
                # the SYNC PDU carries the crypto context's network identity
                # and colour code (the reference updates tcd from the same
                # parse, tetra_lower_mac.c:246-276 + tetra_crypto net info)
                cs = self.upper.crypto_state
                if cs is not None and (cs.mcc != c.mcc or cs.mnc != c.mnc
                                       or cs.cc != c.colour_code):
                    cs.cc = c.colour_code
                    cs.update_network(c.mcc, c.mnc)
                d.last_crc_fail = False
            else:
                d.last_crc_fail = True
            lchan = LC_BSCH
        elif blk_type == P.TPSAP_T_BBK:
            lchan = LC_AACH
        elif blk_type == P.TPSAP_T_SB2:
            lchan = LC_BNCH if is_bnch(time) else LC_UNKNOWN
            d.last_crc_fail = not crc_ok
        elif blk_type == P.TPSAP_T_SCH_F:
            lchan = LC_SCH_F
            if crc_ok:
                d.last_crc_fail = False
            if self.upper.is_traffic and self.voice_cb is not None:
                self.voice_cb(time, type4)
        elif blk_type == P.TPSAP_T_NDB:
            # Clause 19.4.4 slot stealing: a traffic slot transmitted with
            # training sequence 2 carries STCH in its first half block
            # (tetra_lower_mac.c:197-200); the PDUs inside still parse by
            # MAC PDU type like any control block.
            if self.upper.is_traffic and blk_num == 1:
                self.upper.blk1_stolen = True
            if (self.upper.is_traffic and blk_num == 2
                    and self.upper.blk1_stolen
                    and not self.upper.blk2_stolen):
                # Only the first half was stolen: the second half block still
                # carries one speech frame.  The reference drops it
                # (both halves go to signalling); we decode it (+, ROADMAP).
                half_cb = getattr(self.voice_cb, "half", None)
                if half_cb is not None and type4 is not None:
                    half_cb(time, type4)
                return
            d.last_crc_fail = not crc_ok
        else:
            d.last_crc_fail = not crc_ok
        self.upper.receive(type1, lchan, crc_ok, time)

    def process_bursts(self, bursts: list[Burst]):
        """Decode and dispatch a batch of bursts (order preserved)."""
        process_bursts_multi([self], [bursts])

    def _dispatch_decoded(self, items, decoded, bursts):
        """Sequential dispatch of pre-decoded blocks in burst/block order."""
        scramb = self.cell.scramb_init
        up = self.upper
        if items and not up.events_enabled and up.crypto_state is None:
            h = up._native_handle()
            if h is not False:
                self._dispatch_native(h, items, decoded, bursts, scramb)
                return
        self._resync_base = None
        for i, (bi, blk_type, blk_num, type5) in enumerate(items):
            burst = bursts[bi]
            if self._resync_base is not None:
                # restamp bursts that were stamped before the SYNC resync
                base_time, base_idx = self._resync_base
                if burst.slot_index > base_idx:
                    t = base_time.copy()
                    t.add_tn_bulk(burst.slot_index - base_idx)
                    burst.time = t
            type1, ok = decoded[i]
            type4 = None
            if blk_type == P.TPSAP_T_SCH_F or (
                    blk_type == P.TPSAP_T_NDB and blk_num == 2):
                # NDB blk2's descrambled bits are kept in case the slot turns
                # out to be a half-stolen traffic slot (speech in blk2)
                type4 = type5 ^ rx_fec.keystream(scramb, len(type5))
            self.upper.display.curr_multiframe = burst.time.mn
            self.upper.display.curr_frame = burst.time.fn
            # timeslot content per tetra_burst_rx_cb
            tc = {P.TRAIN_SEQ_SYNC: 3, P.TRAIN_SEQ_NORM_2: 2}.get(
                burst.train_seq,
                4 if self.upper.is_traffic else 1)
            self.upper.display.timeslot_content[(burst.time.tn - 1) % 4] = tc
            self._dispatch(blk_type, blk_num, type1, ok, burst.time, type4,
                           burst.slot_index)

    def _dispatch_native(self, h, items, decoded, bursts, scramb):
        """Batched native dispatch: ONE ctypes call (macparse_dispatch) runs
        the whole block loop above for the no-events/no-crypto production
        configuration, then the accumulated display/cell deltas and deferred
        voice work apply here.  Exact-parity tested against the Python loop
        (tests/test_native_mac.py)."""
        from .upper_mac import _nm
        nm = _nm()
        n = len(items)
        bufs, meta, off = [], np.empty((n, 12), np.int64), 0
        for i, (bi, blk_type, blk_num, _type5) in enumerate(items):
            burst = bursts[bi]
            t1 = decoded[i][0]
            if t1.dtype != np.uint8:
                t1 = np.asarray(t1, np.uint8)
            bufs.append(t1)
            t = burst.time
            meta[i] = (off, len(t1), blk_type, blk_num, bool(decoded[i][1]),
                       burst.slot_index, t.tn, t.fn, t.mn, t.hn,
                       burst.train_seq, t.sn)
            off += len(t1)
        bits = np.ascontiguousarray(np.concatenate(bufs))
        up = self.upper
        fin = ((up.is_traffic & 0xFF)
               | (0x100 if up.blk1_stolen else 0)
               | (0x200 if up.blk2_stolen else 0))
        voice_cb = self.voice_cb
        half_cb = getattr(voice_cb, "half", None)
        ct = self.cell.time
        flags, dout, actions, times = h.dispatch(
            bits, meta, fin, voice_cb is not None, half_cb is not None,
            ct.hn, ct.sn)
        # MAC state mirrors (as upper_mac._sync_native)
        up.is_traffic = flags & 0xFF
        up.blk1_stolen = bool(flags & 0x100)
        up.blk2_stolen = bool(flags & 0x200)
        up.addr_type = (flags >> 10) & 7
        up.usage_marker = (flags >> 13) & 0x3F
        up.ssi = (flags >> 32) & 0xFFFFFF
        # display/cell deltas
        d = up.display
        self.crc_oks += int(dout[nm.D_CRC_OK])
        self.crc_fails += int(dout[nm.D_CRC_FAIL])
        if dout[nm.D_LAST_CRC_FAIL] >= 0:
            d.last_crc_fail = bool(dout[nm.D_LAST_CRC_FAIL])
        if dout[nm.D_A_HAVE1]:
            d.access1_code = chr(ord("A") + int(dout[nm.D_A_CODE1]))
            d.access1 = int(dout[nm.D_A_VAL1])
        if dout[nm.D_A_HAVE2]:
            d.access2_code = chr(ord("A") + int(dout[nm.D_A_CODE2]))
            d.access2 = int(dout[nm.D_A_VAL2])
        if dout[nm.D_A_HAVE_DL]:
            d.dl_usage = int(dout[nm.D_A_DL])
        if dout[nm.D_A_HAVE_UL]:
            d.ul_usage = int(dout[nm.D_A_UL])
        if dout[nm.D_SI_SEEN]:
            s = h.st.si
            from . import mac_pdu as p
            up.last_sysinfo = p.SysinfoPdu(
                **{k: getattr(s, k) for k in nm.SYSINFO_FIELDS})
            d.dl_freq = s.dl_freq
            d.ul_freq = s.ul_freq
            for i, name in enumerate(p.BS_SERVICE_FLAGS):
                if name is not None:
                    setattr(d, name, bool(s.bs_service_details & (1 << i)))
        if dout[nm.D_HF_SEEN]:
            d.curr_hyperframe = int(dout[nm.D_HF_VAL])
        for k in range(4):
            if dout[nm.D_CONTENT0 + k] >= 0:
                d.timeslot_content[k] = int(dout[nm.D_CONTENT0 + k])
        if dout[nm.D_LAST_MN] >= 0:
            d.curr_multiframe = int(dout[nm.D_LAST_MN])
            d.curr_frame = int(dout[nm.D_LAST_FN])
        if dout[nm.D_SB1_SEEN]:
            d.mcc = int(dout[nm.D_MCC])
            d.mnc = int(dout[nm.D_MNC])
            d.cc = int(dout[nm.D_CC])
        if dout[nm.D_SB1_OK]:  # last good SYNC PDU -> cell + PHY time resync
            c = self.cell
            c.mcc = int(dout[nm.D_CELL_MCC])
            c.mnc = int(dout[nm.D_CELL_MNC])
            c.colour_code = int(dout[nm.D_CELL_CC])
            c.time.tn = int(dout[nm.D_CELL_TN])
            c.time.fn = int(dout[nm.D_CELL_FN])
            c.time.mn = int(dout[nm.D_CELL_MN])
            c.scramb_init = P.scramb_get_init(c.mcc, c.mnc, c.colour_code)
            lag = self.phy.slot_count - int(dout[nm.D_CELL_SIDX])
            self.phy.time.tn = c.time.tn
            self.phy.time.fn = c.time.fn
            self.phy.time.mn = c.time.mn
            if lag > 0:
                self.phy.time.add_tn_bulk(lag)
        # deferred voice work (order preserved; the callbacks only consume
        # (time, type4) so running them after the batch is equivalent)
        if actions.any():
            for i in np.nonzero(actions)[0]:
                type5 = items[i][3]
                type4 = type5 ^ rx_fec.keystream(scramb, len(type5))
                hn, mn, fn, tn, sn = (int(x) for x in times[i])
                t = TdmaTime(hn, mn, fn, tn, sn)
                if actions[i] == 1:
                    voice_cb(t, type4)
                else:
                    half_cb(t, type4)


def decode_bursts_multi(cells: list[CellData],
                        bursts_list: list[list[Burst]], device):
    """Batched FEC on `device` for many channels' bursts (no dispatch).

    All channels' blocks decode in one fused pass with per-row scrambling
    keystreams; each channel then adopts its own first good SYNC PDU's
    scrambling code and the rows decoded under a stale code decode again,
    as the sequential SB1-first reference flow would.  The number of FEC
    passes stays constant as the channel count grows.

    Mutates each channel's CellData scramb_init on its first good SB1 (the
    one piece of MAC state the decode itself depends on).  Returns
    (all_items, decoded): per channel the block list [(burst_idx, blk_type,
    blk_num, type5)] and {(chan_idx, item_idx): (type1, crc_ok)}.
    """
    all_items = []
    for bursts in bursts_list:
        items = []  # (burst_idx, blk_type, blk_num, type5)
        for bi, burst in enumerate(bursts):
            for blk_type, blk_num, type5 in burst.blocks():
                items.append([bi, blk_type, blk_num, np.asarray(type5)])
        all_items.append(items)

    decoded: dict[tuple[int, int], tuple[np.ndarray, bool]] = {}
    refs = [(mi, i) for mi, items in enumerate(all_items)
            for i in range(len(items))]
    if not refs:
        return all_items, decoded
    # ONE fused decode for every block of every channel and type
    # (rx_fec.decode_blocks_mixed), using each channel's current scrambling
    # code
    rows = [(all_items[mi][i][1], all_items[mi][i][3],
             cells[mi].scramb_init) for mi, i in refs]
    out = rx_fec.decode_blocks_mixed(rows, device)
    for j, (mi, i) in enumerate(refs):
        decoded[(mi, i)] = out[j]

    # adopt each channel's first good SYNC PDU's scrambling code (the one
    # piece of MAC state the decode itself depends on); channels whose code
    # CHANGED had their non-SB1 blocks decoded under the stale code above,
    # so re-decode exactly those rows -- same results as the sequential
    # SB1-first flow, still O(1) extra calls (none in steady state)
    changed = set()
    for mi, i in refs:
        it = all_items[mi][i]
        if it[1] != P.TPSAP_T_SB1 or mi in changed:
            continue
        t1, ok = decoded[(mi, i)]
        if ok:
            mcc = bits_to_uint(t1, 31, 10)
            mnc = bits_to_uint(t1, 41, 14)
            cc = bits_to_uint(t1, 4, 6)
            init = P.scramb_get_init(mcc, mnc, cc)
            if init != cells[mi].scramb_init:
                cells[mi].scramb_init = init
                changed.add(mi)
    if changed:
        refs2 = [(mi, i) for mi, i in refs
                 if mi in changed and all_items[mi][i][1] != P.TPSAP_T_SB1]
        if refs2:
            rows2 = [(all_items[mi][i][1], all_items[mi][i][3],
                      cells[mi].scramb_init) for mi, i in refs2]
            out2 = rx_fec.decode_blocks_mixed(rows2, device)
            for j, (mi, i) in enumerate(refs2):
                decoded[(mi, i)] = out2[j]
    return all_items, decoded


def process_bursts_multi(macs: list[LowerMac],
                         bursts_list: list[list[Burst]]):
    """Decode bursts for many channels (batched FEC on the first LowerMac's
    device) then dispatch per channel in order, exactly as the
    single-channel path."""
    all_items, decoded = decode_bursts_multi(
        [m.cell for m in macs], bursts_list, macs[0].device if macs else None)
    for mi, mac in enumerate(macs):
        if all_items[mi]:
            mac._dispatch_decoded(
                all_items[mi],
                {i: decoded[(mi, i)] for i in range(len(all_items[mi]))},
                bursts_list[mi])
