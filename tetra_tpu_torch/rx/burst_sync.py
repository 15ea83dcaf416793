"""Burst synchronization: training-sequence search + lock state machine
(port of tetra_tpu/rx/burst_sync.py: the host NumPy synchronizer as it is,
and the batched SYNC acquisition on the receiver's torch device).

Re-design of phy/tetra_burst_sync.c + phy/tetra_burst.c:271-341: the bit-serial
22-bit rolling prefilter becomes a vectorized sliding-window correlation over
the whole buffer (NumPy here; device-side batched correlation for wideband
multi-channel operation is ops/train_corr).  The 3-state lock machine
(UNLOCKED -> KNOW_FSTART -> LOCKED) and its slot bookkeeping are inherently
sequential, low-rate host logic and stay in Python, as SURVEY.md section 7
plans (device computes scores, host tracks lock).

Emitted bursts are split into typed field blocks (SB1/BBK/SB2/NDB/SCH-F) per
the downlink burst layouts so callers can batch same-typed blocks for the
device FEC pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from ..ops.train_corr import train_seq_hits
from .tdma import PhyState, TdmaTime

RX_UNLOCKED = 0
RX_KNOW_FSTART = 1
RX_LOCKED = 2

_SEARCH_SEQS_LOCKED = (P.TRAIN_SEQ_SYNC, P.TRAIN_SEQ_NORM_1, P.TRAIN_SEQ_NORM_2)

# byte images for the steady-state expected-offset compares (one C-level
# bytes compare per slot instead of three numpy array_equal dispatches)
_TRAIN_Y_B = np.asarray(P.TRAIN_Y, np.uint8).tobytes()
_TRAIN_N_B = np.asarray(P.TRAIN_N, np.uint8).tobytes()
_TRAIN_P_B = np.asarray(P.TRAIN_P, np.uint8).tobytes()


def find_train_seq(bits: np.ndarray, which: tuple[int, ...]
                   ) -> tuple[int, int] | None:
    """Earliest full match of any requested training sequence.

    Returns (seq_id, offset) of the smallest offset with a complete match, or
    None.  Equivalent to tetra_burst.c:271-341 (prefilter + memcmp) but
    computed as vectorized window compares.
    """
    best = None
    for seq_id in which:
        seq = P.TRAIN_SEQS[seq_id]
        L = len(seq)
        if len(bits) < L:
            continue
        win = np.lib.stride_tricks.sliding_window_view(bits, L)
        hits = np.nonzero((win == seq).all(axis=1))[0]
        if hits.size and (best is None or hits[0] < best[1]):
            best = (seq_id, int(hits[0]))
    return best


@dataclass
class Burst:
    """One received 510-bit downlink slot with its training-sequence type."""
    train_seq: int
    bits: np.ndarray          # (510,) uint8
    time: TdmaTime            # TDMA time at reception
    slot_index: int = 0       # monotonic slot counter at reception

    def blocks(self) -> list[tuple[int, int, np.ndarray]]:
        """Split into (tp_sap_type, blk_num, type5_bits) per burst layout
        (tetra_burst_rx_cb, phy/tetra_burst.c:343-393)."""
        b = self.bits
        if self.train_seq == P.TRAIN_SEQ_SYNC:
            return [
                (P.TPSAP_T_SB1, 1, b[P.SB_BLK1_OFFSET:P.SB_BLK1_OFFSET + P.SB_BLK1_BITS]),
                (P.TPSAP_T_BBK, 0, b[P.SB_BBK_OFFSET:P.SB_BBK_OFFSET + P.SB_BBK_BITS]),
                (P.TPSAP_T_SB2, 2, b[P.SB_BLK2_OFFSET:P.SB_BLK2_OFFSET + P.SB_BLK2_BITS]),
            ]
        bbk = np.concatenate([
            b[P.NDB_BBK1_OFFSET:P.NDB_BBK1_OFFSET + P.NDB_BBK1_BITS],
            b[P.NDB_BBK2_OFFSET:P.NDB_BBK2_OFFSET + P.NDB_BBK2_BITS]])
        if self.train_seq == P.TRAIN_SEQ_NORM_2:
            return [
                (P.TPSAP_T_BBK, 0, bbk),
                (P.TPSAP_T_NDB, 1, b[P.NDB_BLK1_OFFSET:P.NDB_BLK1_OFFSET + P.NDB_BLK_BITS]),
                (P.TPSAP_T_NDB, 2, b[P.NDB_BLK2_OFFSET:P.NDB_BLK2_OFFSET + P.NDB_BLK_BITS]),
            ]
        if self.train_seq == P.TRAIN_SEQ_NORM_1:
            schf = np.concatenate([
                b[P.NDB_BLK1_OFFSET:P.NDB_BLK1_OFFSET + P.NDB_BLK_BITS],
                b[P.NDB_BLK2_OFFSET:P.NDB_BLK2_OFFSET + P.NDB_BLK_BITS]])
            return [
                (P.TPSAP_T_BBK, 0, bbk),
                (P.TPSAP_T_SCH_F, 0, schf),
            ]
        return []  # uplink training sequences: ignore (NORM_3 / EXT)


@dataclass
class BurstSync:
    """Per-channel burst synchronizer (state of tetra_burst_sync.h:12-20).

    bufsize bounds memory while UNLOCKED (the reference uses 4096 bits with
    tiny stream feeds); batch feeds here are block-sized (~4k bits per demod
    block), so the bound must comfortably exceed feed size + one slot or the
    ring would drop unprocessed bits and break alignment.
    """
    bufsize: int = 1 << 16
    state: int = RX_UNLOCKED
    bitbuf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    bitbuf_start_bitnum: int = 0
    next_frame_start_bitnum: int = 0
    phy: PhyState = field(default_factory=PhyState)
    lock_losses: int = 0
    # UNLOCKED-scan bookkeeping: absolute bitnum below which the buffer is
    # known to contain no SYNC training-sequence start, so repeated feeds
    # never rescan it (the reference rescans its whole 4096-bit ring every
    # call, tetra_burst_sync.c:75).
    scan_from: int = 0
    # device-acquisition result staged by device_acquire_scan():
    # (abs offset of earliest SYNC hit or -1, abs bitnum scanned up to)
    pending_scan: tuple[int, int] | None = None

    @property
    def time(self) -> TdmaTime:
        return self.phy.time

    def _unlock(self):
        """Drop lock and discard stale buffered bits beyond the reference's
        4096-bit window.  Our buffer is 16x the reference's (block feeds),
        so after a signal gap it can still hold minutes-old bursts whose
        training sequences re-acquisition would otherwise latch onto --
        a false lock that consumes the whole stale region slot-by-slot
        before the live stream is reached (tetra_burst_sync.c bounds this
        staleness to 8 slots by construction)."""
        self.state = RX_UNLOCKED
        self.lock_losses += 1
        keep = 4096
        if len(self.bitbuf) > keep:
            drop = len(self.bitbuf) - keep
            self.bitbuf = self.bitbuf[drop:]
            self.bitbuf_start_bitnum += drop
        self.scan_from = self.bitbuf_start_bitnum
        self.pending_scan = None

    def feed(self, bits: np.ndarray) -> list[Burst]:
        """Append demodulated bits; return any completed bursts."""
        bits = np.asarray(bits, np.uint8).reshape(-1)
        # keep at most bufsize bits (make_bitbuf_space)
        total = len(self.bitbuf) + len(bits)
        if total > self.bufsize:
            drop = total - self.bufsize
            self.bitbuf = self.bitbuf[drop:]
            self.bitbuf_start_bitnum += drop
        self.bitbuf = np.concatenate([self.bitbuf, bits])

        out: list[Burst] = []
        progress = True
        while progress:
            progress = False
            if self.state == RX_UNLOCKED:
                if len(self.bitbuf) < P.BITS_PER_TS * 2:
                    break
                m = None
                if self.pending_scan is not None:
                    # result of a batched device correlation scan staged by
                    # device_acquire_scan(): trust it for the region it
                    # covered, fall through to the host search only for
                    # bits appended after it ran
                    hit, upto = self.pending_scan
                    self.pending_scan = None
                    if hit >= self.bitbuf_start_bitnum:
                        m = (P.TRAIN_SEQ_SYNC,
                             hit - self.bitbuf_start_bitnum)
                    else:
                        self.scan_from = max(self.scan_from, upto)
                if m is None:
                    # resume the host scan where previous feeds left off
                    # (a window may straddle the seam, hence the -L+1 lap)
                    L = len(P.TRAIN_SEQS[P.TRAIN_SEQ_SYNC])
                    start = max(0, self.scan_from
                                - self.bitbuf_start_bitnum - (L - 1))
                    f = find_train_seq(self.bitbuf[start:],
                                       (P.TRAIN_SEQ_SYNC,))
                    if f is not None:
                        m = (f[0], f[1] + start)
                if m is None:
                    self.scan_from = (self.bitbuf_start_bitnum
                                      + len(self.bitbuf))
                    break
                _, offs = m
                self.state = RX_KNOW_FSTART
                self.next_frame_start_bitnum = (
                    self.bitbuf_start_bitnum + offs + P.SYNC_TRAIN_TO_NEXT_SLOT)
                # (+) decode the ANCHOR burst itself: the y we aligned on
                # sits at slot offset 214, so its whole 510-bit slot is
                # already buffered whenever offs >= 214.  The reference
                # discards it (KNOW_FSTART waits for the NEXT slot,
                # tetra_burst_sync.c:80-91), costing up to a full 72-slot
                # SYNC period before the scrambling code is known; emitting
                # it here cuts time-to-first-SYNC-PDU to zero.
                a0 = offs - P.SYNC_TRAIN_OFFSET
                if a0 >= 0 and a0 + P.BITS_PER_TS <= len(self.bitbuf):
                    self.time.add_tn(1)
                    self.phy.slot_count += 1
                    out.append(Burst(P.TRAIN_SEQ_SYNC,
                                     self.bitbuf[a0:a0 + P.BITS_PER_TS].copy(),
                                     self.time.copy(),
                                     self.phy.slot_count))
                progress = True
            elif self.state == RX_KNOW_FSTART:
                if (self.bitbuf_start_bitnum + len(self.bitbuf)
                        < self.next_frame_start_bitnum):
                    break
                offset = self.next_frame_start_bitnum - self.bitbuf_start_bitnum
                self.bitbuf = self.bitbuf[offset:]
                self.bitbuf_start_bitnum += offset
                self.next_frame_start_bitnum += P.BITS_PER_TS
                self.state = RX_LOCKED
                progress = True
            else:  # RX_LOCKED
                if len(self.bitbuf) < P.BITS_PER_TS:
                    break
                self.time.add_tn(1)
                self.phy.slot_count += 1
                # Steady-state fast path: a well-aligned burst matches at
                # its EXPECTED offset (y@214 / n,p@244), so check those two
                # positions with direct compares before any scan -- O(38)
                # instead of O(slot*seqs) per slot, which dominated the
                # host profile at 64+ channels.  (Deviation from the
                # reference's earliest-match scan only in the ~2e-4/slot
                # case where a random payload coincidence precedes the real
                # training sequence -- where accepting the correctly-placed
                # burst is strictly better than ignoring/unlocking.)
                buf = self.bitbuf
                m = None
                o = P.SYNC_TRAIN_OFFSET
                if buf[o:o + len(P.TRAIN_Y)].tobytes() == _TRAIN_Y_B:
                    m = (P.TRAIN_SEQ_SYNC, o)
                else:
                    o = P.NORM_TRAIN_OFFSET
                    seg = buf[o:o + len(P.TRAIN_N)].tobytes()
                    if seg == _TRAIN_N_B:
                        m = (P.TRAIN_SEQ_NORM_1, o)
                    elif seg == _TRAIN_P_B:
                        m = (P.TRAIN_SEQ_NORM_2, o)
                if m is None:
                    m = find_train_seq(self.bitbuf[:P.BITS_PER_TS + 64],
                                       _SEARCH_SEQS_LOCKED)
                if m is None:
                    m = find_train_seq(self.bitbuf, _SEARCH_SEQS_LOCKED)
                if m is None:
                    self._unlock()
                else:
                    seq_id, offs = m
                    if seq_id == P.TRAIN_SEQ_SYNC:
                        if offs == P.SYNC_TRAIN_OFFSET:
                            out.append(Burst(seq_id,
                                             self.bitbuf[:P.BITS_PER_TS].copy(),
                                             self.time.copy(),
                                             self.phy.slot_count))
                        else:
                            # a SYNC training sequence at the wrong offset
                            # means our slot alignment slipped -- but the y
                            # we just saw IS a fresh acquisition: re-align
                            # to it directly instead of unlocking and
                            # waiting up to 72 slots for the next SYNC
                            # burst (+ vs reference, which just unlocks
                            # and usually consumes this y with the slot,
                            # tetra_burst_sync.c:121-127)
                            self.lock_losses += 1
                            self.state = RX_KNOW_FSTART
                            self.next_frame_start_bitnum = (
                                self.bitbuf_start_bitnum + offs
                                + P.SYNC_TRAIN_TO_NEXT_SLOT)
                            progress = True
                            continue
                    else:
                        if offs == P.NORM_TRAIN_OFFSET:
                            out.append(Burst(seq_id,
                                             self.bitbuf[:P.BITS_PER_TS].copy(),
                                             self.time.copy(),
                                             self.phy.slot_count))
                        # wrong-offset NORM: ignored, stay locked (reference
                        # behavior at tetra_burst_sync.c:134-139)
                self.bitbuf = self.bitbuf[P.BITS_PER_TS:]
                self.bitbuf_start_bitnum += P.BITS_PER_TS
                self.next_frame_start_bitnum += P.BITS_PER_TS
                progress = True
        return out


def device_acquire_scan(syncs: list["BurstSync"],
                        bits_list: list[np.ndarray],
                        pad_channels: int | None = None,
                        pad_quantum: int = 4096, device=None) -> None:
    """Batched SYNC acquisition for UNLOCKED channels on `device` (the
    current CUDA device unless the caller asks for the CPU).

    For each (sync, new_bits) pair, correlates the channel's unscanned buffer
    tail plus its incoming bits against the SYNC training sequence in ONE
    device call for all channels (ops/train_corr), and stages the earliest
    hit on `sync.pending_scan` for the next `feed()` to consume.  This moves
    the O(buffer x channels) acquisition search off the host: the per-channel
    Python scans of the reference's bit-serial matcher (tetra_burst.c:271-341)
    were the startup/dropout hot spot at 256+ channels.

    The matrix is (pad_channels, k*pad_quantum), as the JAX package shapes
    it for one compiled program per quantum step.  Rows are padded with an
    alternating 01 pattern that cannot contain a training sequence, and hits
    whose window would extend past a row's true length are masked out.
    """
    if not syncs:
        return
    L_seq = len(P.TRAIN_SEQS[P.TRAIN_SEQ_SYNC])
    regions, bases = [], []
    for s, bits in zip(syncs, bits_list):
        bits = np.asarray(bits, np.uint8).reshape(-1)
        start = max(0, s.scan_from - s.bitbuf_start_bitnum - (L_seq - 1))
        region = np.concatenate([s.bitbuf[start:], bits])
        regions.append(region)
        bases.append(s.bitbuf_start_bitnum + start)
    maxlen = max(len(r) for r in regions)
    C = pad_channels if pad_channels is not None else len(syncs)
    Lp = max(pad_quantum, -(-maxlen // pad_quantum) * pad_quantum)
    mat = np.empty((C, Lp), np.uint8)
    mat[:] = (np.arange(Lp) & 1).astype(np.uint8)  # 0101... never matches
    for i, r in enumerate(regions):
        mat[i, :len(r)] = r
    sync_mask = train_seq_hits(torch.from_numpy(mat).to(
        resolve_device(device)))[P.TRAIN_SEQ_SYNC].cpu().numpy()
    for i, s in enumerate(syncs):
        row = sync_mask[i, :max(0, len(regions[i]) - L_seq + 1)]
        hits = np.nonzero(row)[0]
        scanned_upto = bases[i] + len(regions[i])
        if hits.size:
            s.pending_scan = (bases[i] + int(hits[0]), scanned_upto)
        else:
            s.pending_scan = (-1, scanned_upto)
