"""One cell's downlink bit stream over a whole number of multiframes: a
frozen copy of the signalling arm of the program's TX fixture
(tx.cell.downlink_bits with tx.fec_enc and tx.burst), in plain NumPy.

Every slot is a SYNC burst on the BSCH slot rule (SYNC + SYSINFO PDUs)
or a normal burst on two logical channels: a NULL MAC-RESOURCE in block
1 and a MAC-RESOURCE carrying an SDS payload drawn from the payload RNG
in block 2, with the ACCESS-ASSIGN broadcast block between them.  Type-1
bits -> CRC-16 + tail -> rate-1/4 K=5 mother code -> rate-2/3 puncture
-> block interleave -> scramble (EN 300 392-2 clause 8.2); bursts as
clause 9.4.4.2.5/6 with their phase-adjustment bits.

The returned records are the ground truth: for slot p, the type-1 bits
of every block keyed by (block type, block number), the numbering the
fleet engine gives its rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import protocol as P


def _bits(val: int, n: int) -> np.ndarray:
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


@dataclass(frozen=True)
class Cell:
    mcc: int
    mnc: int
    cc: int
    main_carrier: int = 3600
    freq_band: int = 3
    la: int = 21
    bs_service_details: int = 0b111001110111
    hyperframe: int = 42


def slot_time(p: int, mn0: int = 1) -> tuple[int, int, int]:
    """(multiframe, frame, timeslot) of slot p counted from the first
    timeslot of multiframe mn0."""
    return mn0 + p // P.SLOTS_PER_MULTIFRAME, (p % 72) // 4 + 1, p % 4 + 1


def is_bsch(mn: int, fn: int, tn: int) -> bool:
    """The BSCH slot rule: frame 18, timeslot 4 - ((mn + 1) mod 4)."""
    return fn == 18 and tn == 4 - ((mn + 1) % 4)


# -- PDUs --------------------------------------------------------------------

def sync_pdu(cell: Cell, mn: int, fn: int, tn: int) -> np.ndarray:
    """60-bit SYNC PDU with D-MLE-SYNC (21.4.4.2)."""
    return np.concatenate([
        _bits(0, 4), _bits(cell.cc, 6), _bits(tn - 1, 2), _bits(fn, 5),
        _bits(mn, 6), _bits(0, 2), _bits(0, 3), _bits(0, 1), _bits(0, 1),
        _bits(0, 1), _bits(cell.mcc, 10), _bits(cell.mnc, 14), _bits(0, 2),
        _bits(0, 2), _bits(0, 1)])


def sysinfo_pdu(cell: Cell) -> np.ndarray:
    """124-bit BROADCAST/SYSINFO PDU with D-MLE-SYSINFO (21.4.4.1)."""
    return np.concatenate([
        _bits(2, 2), _bits(0, 2), _bits(cell.main_carrier, 12),
        _bits(cell.freq_band, 4), _bits(0, 2), _bits(0, 3), _bits(0, 1),
        _bits(0, 2), _bits(4, 3), _bits(2, 4), _bits(3, 4), _bits(2, 4),
        _bits(0, 1), _bits(cell.hyperframe, 16), _bits(2, 2), _bits(0, 20),
        _bits(cell.la, 14), _bits(0xFFFF, 16),
        _bits(cell.bs_service_details, 12)])


def aach_pdu() -> np.ndarray:
    """14-bit ACCESS-ASSIGN: header 3, downlink usage 2 (common control)."""
    return np.concatenate([_bits(3, 2), _bits(2, 6), _bits(0, 6)])


def null_pdu() -> np.ndarray:
    """MAC-RESOURCE with the NULL address, zero-padded to 124 bits."""
    head = np.concatenate([_bits(0, 2), _bits(0, 1), _bits(0, 1), _bits(0, 2),
                           _bits(0, 1), _bits(0, 6), _bits(0, 3)])
    return np.concatenate([head, np.zeros(124 - len(head), np.uint8)])


def sds_pdu(payload: np.ndarray) -> np.ndarray:
    """MAC-RESOURCE to SSI 0x123456 carrying LLC BL-UDATA / CMCE D-SDS-DATA
    with a 65-bit payload (21.4.3.1), zero-padded to 124 bits."""
    sdu = np.concatenate([_bits(2, 4), _bits(2, 3), _bits(0x0F, 5),
                          np.asarray(payload, np.uint8)])
    total = 43 + len(sdu)
    octets = (total + 7) // 8
    bits = np.concatenate([
        _bits(0, 2), _bits(0, 1), _bits(0, 1), _bits(0, 2), _bits(0, 1),
        _bits(octets, 6), _bits(1, 3), _bits(0x123456, 24), _bits(0, 1),
        _bits(0, 1), _bits(0, 1), sdu, np.zeros(octets * 8 - total, np.uint8)])
    return np.concatenate([bits, np.zeros(124 - len(bits), np.uint8)])


# -- block coding (clause 8.2) ---------------------------------------------

def _crc16(bits: np.ndarray) -> np.ndarray:
    crc = P.CRC16_INIT
    for b in bits:
        crc ^= int(b) << 15
        crc = ((crc << 1) ^ P.CRC16_POLY) & 0xFFFF if crc & 0x8000 \
            else (crc << 1) & 0xFFFF
    crc ^= 0xFFFF
    return _bits(crc, 16)


def _conv(bits: np.ndarray) -> np.ndarray:
    n_out, K = P.CONV_POLYS.shape
    hist = np.zeros((K, len(bits)), np.int32)
    for d in range(K):
        hist[d, d:] = bits[:len(bits) - d]
    return ((P.CONV_POLYS.astype(np.int32) @ hist) % 2).T.reshape(-1) \
        .astype(np.uint8)


def _puncture_idx(out_len: int) -> np.ndarray:
    pt, t, period = P.PUNCT_2_3
    j = np.arange(1, out_len + 1)
    blk = (j - 1) // t
    return period * blk + np.asarray(pt)[j - t * blk] - 1


def _keystream(init: int, n: int) -> np.ndarray:
    out = np.empty(n, np.uint8)
    lfsr = init & 0xFFFFFFFF
    for i in range(n):
        bit = 0
        for t in P.SCRAMB_TAPS:
            bit ^= lfsr >> (32 - t)
        bit &= 1
        lfsr = (lfsr >> 1) | (bit << 31)
        out[i] = bit
    return out


class Encoder:
    """type-1 -> type-5 for one cell (keystreams computed once)."""

    def __init__(self, scramb: int):
        self._ks = {n: (_keystream(scramb, n), _keystream(P.SCRAMB_INIT, n))
                    for n in (30, 120, 216)}

    def encode(self, type1: np.ndarray, blk: int) -> np.ndarray:
        t5, t2, t1, a = P.BLOCKS[blk]
        if len(type1) != t1:
            raise ValueError(f"block {blk}: {len(type1)} type-1 bits, not {t1}")
        if blk == P.T_BBK:
            t4 = np.concatenate([type1, (type1.astype(np.int32)
                                         @ P.RM3014_PARITY) % 2]) \
                .astype(np.uint8)
        else:
            t2b = np.concatenate([type1, _crc16(type1),
                                  np.zeros(4, np.uint8)])
            t3 = _conv(t2b)[_puncture_idx(t5)]
            t4 = np.empty_like(t3)
            t4[(a * np.arange(1, t5 + 1)) % t5] = t3
        ks, ks_init = self._ks[t5]
        return t4 ^ (ks_init if blk == P.T_SB1 else ks)


# -- bursts (clause 9.4.4.2.5/6) ---------------------------------------------

_PHASE_RANGES = {"HA": (8, 122), "HB": (123, 249), "HC": (8, 108),
                 "HD": (109, 249)}
_PHASE_BITS = {1: (0, 0), 3: (0, 1), -1: (1, 0), -3: (1, 1)}


def _phase_adj(burst: np.ndarray, which: str) -> np.ndarray:
    n1, n2 = _PHASE_RANGES[which]
    seg = burst[2 * (n1 - 1):2 * n2]
    adj = -(int(P.DIBIT_STEP[(seg[0::2] << 1) | seg[1::2]].sum()) % 8)
    adj = adj - 8 if adj > 3 else adj + 8 if adj < -3 else adj
    return np.array(_PHASE_BITS[adj], np.uint8)


def sync_burst(sb1: np.ndarray, bbk: np.ndarray, sb2: np.ndarray):
    b = np.zeros(510, np.uint8)
    b[0:12] = P.TRAIN_Q[10:22]
    b[14:94] = P.FREQ_CORR
    b[94:214] = sb1
    b[214:252] = P.TRAIN_Y
    b[252:282] = bbk
    b[282:498] = sb2
    b[500:510] = P.TRAIN_Q[0:10]
    b[12:14] = _phase_adj(b, "HC")
    b[498:500] = _phase_adj(b, "HD")
    return b


def norm2_burst(blk1: np.ndarray, bbk: np.ndarray, blk2: np.ndarray):
    """Normal burst on two logical channels (training sequence p)."""
    b = np.zeros(510, np.uint8)
    b[0:12] = P.TRAIN_Q[10:22]
    b[14:230] = blk1
    b[230:244] = bbk[:14]
    b[244:266] = P.TRAIN_P
    b[266:282] = bbk[14:30]
    b[282:498] = blk2
    b[500:510] = P.TRAIN_Q[0:10]
    b[12:14] = _phase_adj(b, "HA")
    b[498:500] = _phase_adj(b, "HB")
    return b


def downlink(cell: Cell, n_slots: int, rng: np.random.Generator,
             mn0: int = 1) -> tuple[np.ndarray, list[dict]]:
    """n_slots consecutive downlink slots from the first timeslot of
    multiframe mn0.  Returns (bits (n_slots * 510,) uint8, records):
    records[p] maps (block type, block number) to the type-1 bits sent
    in slot p."""
    enc = Encoder(P.scramb_init(cell.mcc, cell.mnc, cell.cc))
    aach = aach_pdu()
    bbk5 = enc.encode(aach, P.T_BBK)
    null = null_pdu()
    null5 = enc.encode(null, P.T_NDB)
    sysinfo = sysinfo_pdu(cell)
    sysinfo5 = enc.encode(sysinfo, P.T_SB2)
    out, records = [], []
    for p in range(n_slots):
        mn, fn, tn = slot_time(p, mn0)
        if is_bsch(mn, fn, tn):
            sb1 = sync_pdu(cell, mn, fn, tn)
            out.append(sync_burst(enc.encode(sb1, P.T_SB1), bbk5, sysinfo5))
            records.append({(P.T_SB1, 1): sb1, (P.T_BBK, 0): aach,
                            (P.T_SB2, 2): sysinfo})
        else:
            sds = sds_pdu(rng.integers(0, 2, 65).astype(np.uint8))
            out.append(norm2_burst(null5, bbk5, enc.encode(sds, P.T_NDB)))
            records.append({(P.T_BBK, 0): aach, (P.T_NDB, 1): null,
                            (P.T_NDB, 2): sds})
    return np.concatenate(out), records
