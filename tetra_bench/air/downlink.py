"""One cell's downlink bit stream over a whole number of multiframes: a
frozen copy of the program's TX fixture (tx.cell.downlink_bits with
tx.fec_enc and tx.burst): its signalling arm, and its voice, slot-stealing
and TEA1 arms, in plain NumPy.

Signalling: every slot is a SYNC burst on the BSCH slot rule (SYNC +
SYSINFO PDUs) or a normal burst on two logical channels: a NULL
MAC-RESOURCE in block 1 and a MAC-RESOURCE carrying an SDS payload drawn
from the payload RNG in block 2, with the ACCESS-ASSIGN broadcast block
between them.  Type-1 bits -> CRC-16 + tail -> rate-1/4 K=5 mother code ->
rate-2/3 puncture -> block interleave -> scramble (EN 300 392-2 clause
8.2); bursts as clause 9.4.4.2.5/6 with their phase-adjustment bits.

Voice (`Voice`): the traffic timeslots carry, outside frame 18 and the
BSCH slot, two codec frames a slot from the frame generator, speech
channel coded (speech.py) on a normal burst of one logical channel
(training sequence 1), with the ACCESS-ASSIGN marking traffic.  A steal
(clause 19.4.4) sends training sequence 2: "both" puts STCH in both
halves, the first announcing the second (length indicator 0x3E); "first"
puts STCH in the first and the second frame, half-slot coded, in the
second.  TEA1 (`Crypto`, cipher.py): the codec frames and the SDS
MAC-RESOURCE's TM-SDU are XORed with the slot's keystream (IV from the
slot's time and the cell's hyperframe), and SYSINFO carries the CCK id in
odd multiframes and the hyperframe number in even ones; a periodic
stream ciphers its first multiframe up to the BSCH slot as the multiframe
after its last (_keystreams), so a receiver decrypts every slot across
the wrap, where the multiframe number jumps back.  The frame that
survives a first-half steal is traffic of the encrypted call too, and is
XORed with the keystream bits that lie over the second frame of a full
slot (keystream bits 137-273); here the air departs from the fixture,
which sends it in the clear.  The STCH PDUs, whose headers mark them
unencrypted, go in the clear, as the fixture sends them.

The returned records are the ground truth: for slot p, the type-1 bits
of every block as sent on air (ciphertext where encrypted) keyed by
(block type, block number), the numbering the fleet engine gives its
rows; a voice slot adds "frames", its two plaintext codec frames, and a
stolen slot "steal", its kind, with "half_frame", the plaintext frame
that survives, for a first-half steal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import cipher
from . import protocol as P
from . import speech


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


@dataclass(frozen=True)
class Voice:
    """The traffic arm: the timeslots that carry voice, the codec frame
    generator (called once a slot that sends speech, returning (2, 137)
    uint8), and the steals by (frame, timeslot): "first" or "both"."""
    timeslots: frozenset
    frames: object
    steals: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Crypto:
    """TEA1 on the cell: its 80-bit common cipher key and the key's id."""
    key: bytes
    cck_id: int


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


def sysinfo_pdu(cell: Cell, cck_id: int | None = None) -> np.ndarray:
    """124-bit BROADCAST/SYSINFO PDU with D-MLE-SYSINFO (21.4.4.1); its
    17-bit arm carries the hyperframe number, or with cck_id the common
    cipher key's id."""
    return np.concatenate([
        _bits(2, 2), _bits(0, 2), _bits(cell.main_carrier, 12),
        _bits(cell.freq_band, 4), _bits(0, 2), _bits(0, 3), _bits(0, 1),
        _bits(0, 2), _bits(4, 3), _bits(2, 4), _bits(3, 4), _bits(2, 4),
        _bits(0 if cck_id is None else 1, 1),
        _bits(cell.hyperframe if cck_id is None else cck_id, 16),
        _bits(2, 2), _bits(0, 20),
        _bits(cell.la, 14), _bits(0xFFFF, 16),
        _bits(cell.bs_service_details, 12)])


def aach_pdu(dl_usage: int = 2) -> np.ndarray:
    """14-bit ACCESS-ASSIGN: header 3, downlink usage 2 (common control)
    or 5 (traffic)."""
    return np.concatenate([_bits(3, 2), _bits(dl_usage, 6), _bits(0, 6)])


def null_pdu() -> np.ndarray:
    """MAC-RESOURCE with the NULL address, zero-padded to 124 bits."""
    head = np.concatenate([_bits(0, 2), _bits(0, 1), _bits(0, 1), _bits(0, 2),
                           _bits(0, 1), _bits(0, 6), _bits(0, 3)])
    return np.concatenate([head, np.zeros(124 - len(head), np.uint8)])


def resource_pdu(ssi: int, sdu: np.ndarray, keystream=None,
                 second_half_stolen: bool = False) -> np.ndarray:
    """MAC-RESOURCE to an SSI carrying a TM-SDU (21.4.3.1), zero-padded to
    124 bits: length-delimited to whole octets, or with length indicator
    0x3E where the second half slot is stolen too.  With a keystream the
    encryption mode is 1 and the TM-SDU and its octet padding are XORed
    with its first bits."""
    total = 43 + len(sdu)
    octets = 0x3E if second_half_stolen else (total + 7) // 8
    pad = 124 - total if second_half_stolen else octets * 8 - total
    bits = np.concatenate([
        _bits(0, 2), _bits(0, 1), _bits(0, 1),
        _bits(0 if keystream is None else 1, 2), _bits(0, 1),
        _bits(octets, 6), _bits(1, 3), _bits(ssi, 24), _bits(0, 1),
        _bits(0, 1), _bits(0, 1), sdu, np.zeros(pad, np.uint8)])
    if keystream is not None:
        bits[43:] ^= keystream[:len(bits) - 43]
    return np.concatenate([bits, np.zeros(124 - len(bits), np.uint8)])


def sds_pdu(payload: np.ndarray, keystream=None) -> np.ndarray:
    """MAC-RESOURCE to SSI 0x123456 carrying LLC BL-UDATA / CMCE D-SDS-DATA
    with a 65-bit payload."""
    sdu = np.concatenate([_bits(2, 4), _bits(2, 3), _bits(0x0F, 5),
                          np.asarray(payload, np.uint8)])
    return resource_pdu(0x123456, sdu, keystream)


def stch_pdu(pdu_type: int, payload: np.ndarray,
             second_half_stolen: bool = False) -> np.ndarray:
    """STCH MAC-RESOURCE to SSI 0x654321: LLC BL-UDATA / CMCE pdu_type
    (D-ALERT 0, D-CONNECT ACK 3) with a 40-bit payload."""
    sdu = np.concatenate([_bits(2, 4), _bits(2, 3), _bits(pdu_type, 5),
                          np.asarray(payload, np.uint8)])
    return resource_pdu(0x654321, sdu,
                        second_half_stolen=second_half_stolen)


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
        self._ks_slot = _keystream(scramb, 432)

    def scramble(self, type4: np.ndarray) -> np.ndarray:
        """type-4 -> type-5 bits of a traffic slot or half slot (the
        cell's scrambling sequence from its start)."""
        return type4 ^ self._ks_slot[:len(type4)]

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


def norm2_burst(blk1: np.ndarray, bbk: np.ndarray, blk2: np.ndarray,
                train: np.ndarray = P.TRAIN_P):
    """Normal burst on two logical channels (training sequence p), or on
    one with train = TRAIN_N."""
    b = np.zeros(510, np.uint8)
    b[0:12] = P.TRAIN_Q[10:22]
    b[14:230] = blk1
    b[230:244] = bbk[:14]
    b[244:266] = train
    b[266:282] = bbk[14:30]
    b[282:498] = blk2
    b[500:510] = P.TRAIN_Q[0:10]
    b[12:14] = _phase_adj(b, "HA")
    b[498:500] = _phase_adj(b, "HB")
    return b


def _keystreams(cell: Cell, crypto: Crypto, n_slots: int, first: int,
                mn0: int, wrap: int | None) -> np.ndarray:
    """(n_slots, 274) TEA1 keystream bits of each slot's time: the two codec
    frames' worth, of which a TM-SDU takes the first bits.  With `wrap`,
    the stream repeats after `wrap` multiframes, and the slots of its
    first multiframe before that multiframe's BSCH slot are ciphered under
    multiframe mn0 + wrap: the number a receiver that follows the SYNC
    PDUs gives them, counting on from the last multiframe until the SYNC
    PDU that takes it back."""
    t = np.array([slot_time(p + first, mn0) for p in range(n_slots)])
    if wrap is not None:
        bsch = next(p for p in range(P.SLOTS_PER_MULTIFRAME)
                    if is_bsch(mn0, *slot_time(p, mn0)[1:]))
        t[(t[:, 0] == mn0) & (np.arange(n_slots) + first < bsch), 0] += wrap
    iv = cipher.build_iv(t[:, 0], t[:, 1], t[:, 2], cell.hyperframe)
    eck = cipher.tb5(cell.main_carrier, cell.la, cell.cc, crypto.key)
    return cipher.keystream_bits(iv, eck, 2 * speech.FRAME_BITS)


def downlink(cell: Cell, n_slots: int, rng: np.random.Generator,
             mn0: int = 1, first: int = 0, voice: Voice | None = None,
             crypto: Crypto | None = None,
             wrap: int | None = None) -> tuple[np.ndarray, list[dict]]:
    """n_slots consecutive downlink slots, slot p at the time of slot
    p + first counted from the first timeslot of multiframe mn0.  Returns
    (bits (n_slots * 510,) uint8, records): records[p] maps (block type,
    block number) to the type-1 bits sent in slot p, and holds the voice
    arm's frames (see the module's note).  Without voice and crypto the
    slots are signalling only.  wrap: the multiframes after which a
    periodic stream repeats, for the cipher's IV (_keystreams)."""
    enc = Encoder(P.scramb_init(cell.mcc, cell.mnc, cell.cc))
    aach = aach_pdu()
    bbk5 = enc.encode(aach, P.T_BBK)
    null = null_pdu()
    null5 = enc.encode(null, P.T_NDB)
    sysinfo = sysinfo_pdu(cell)
    sysinfo5 = enc.encode(sysinfo, P.T_SB2)
    if voice is not None:
        aach_t = aach_pdu(dl_usage=5)
        bbk5_t = enc.encode(aach_t, P.T_BBK)
    if crypto is not None:
        ks = _keystreams(cell, crypto, n_slots, first, mn0, wrap)
        sysinfo_cck = sysinfo_pdu(cell, crypto.cck_id)
        sysinfo5_cck = enc.encode(sysinfo_cck, P.T_SB2)
    out, records = [], []
    for p in range(n_slots):
        mn, fn, tn = slot_time(p + first, mn0)
        ksp = None if crypto is None else ks[p]
        if is_bsch(mn, fn, tn):
            sb1 = sync_pdu(cell, mn, fn, tn)
            si, si5 = (sysinfo_cck, sysinfo5_cck) \
                if crypto is not None and mn % 2 == 1 else (sysinfo, sysinfo5)
            out.append(sync_burst(enc.encode(sb1, P.T_SB1), bbk5, si5))
            records.append({(P.T_SB1, 1): sb1, (P.T_BBK, 0): aach,
                            (P.T_SB2, 2): si})
        elif voice is not None and tn in voice.timeslots and fn != 18:
            steal = voice.steals.get((fn, tn))
            if steal is None:
                frames = np.asarray(voice.frames(), np.uint8)
                tx = frames if ksp is None else \
                    frames ^ ksp.reshape(2, speech.FRAME_BITS)
                t5 = enc.scramble(speech.encode_slot(tx))
                out.append(norm2_burst(t5[:216], bbk5_t, t5[216:],
                                       train=P.TRAIN_N))
                records.append({(P.T_BBK, 0): aach_t, "frames": frames})
                continue
            stch1 = stch_pdu(0x00, rng.integers(0, 2, 40).astype(np.uint8),
                             second_half_stolen=steal == "both")
            rec = {(P.T_NDB, 1): stch1, (P.T_BBK, 0): aach_t,
                   "steal": steal}
            if steal == "both":
                stch2 = stch_pdu(0x03,
                                 rng.integers(0, 2, 40).astype(np.uint8))
                blk2 = enc.encode(stch2, P.T_NDB)
                rec[(P.T_NDB, 2)] = stch2
            else:
                half = np.asarray(voice.frames(), np.uint8).reshape(2, -1)[1]
                tx = half if ksp is None else half ^ ksp[speech.FRAME_BITS:]
                blk2 = enc.scramble(speech.encode_half_slot(tx))
                rec["half_frame"] = half
            out.append(norm2_burst(enc.encode(stch1, P.T_NDB), bbk5_t, blk2))
            records.append(rec)
        else:
            sds = sds_pdu(rng.integers(0, 2, 65).astype(np.uint8), ksp)
            out.append(norm2_burst(null5, bbk5, enc.encode(sds, P.T_NDB)))
            records.append({(P.T_BBK, 0): aach, (P.T_NDB, 1): null,
                            (P.T_NDB, 2): sds})
    return np.concatenate(out), records
