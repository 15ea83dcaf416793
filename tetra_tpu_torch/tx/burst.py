"""Downlink burst construction (ETSI 9.4.4.2.5/9.4.4.2.6), host NumPy.

Re-creates the capability of the reference's latent TX-side builders
(phy/tetra_burst.c:133-269): 510-bit synchronization and normal continuous
downlink bursts, including phase-adjustment bit computation.
"""

from __future__ import annotations

import numpy as np

from .. import params as P

# Dibit value d = first_bit<<1 | second_bit  ->  phase change in pi/4 units
# (ETSI table 9.14: 00 -> +pi/4, 01 -> +3pi/4, 10 -> -pi/4, 11 -> -3pi/4)
DIBIT_TO_PHASE = np.array([1, 3, -1, -3], np.int32)

_PHASE_TO_BITS = {1: (0, 0), 3: (0, 1), -1: (1, 0), -3: (1, 1)}

# Phase-adjustment symbol ranges (1-based symbol indices n1..n2, ETSI table 8.14)
PHASE_ADJ_RANGES = {
    "HA": (8, 122), "HB": (123, 249), "HC": (8, 108), "HD": (109, 249),
    "HE": (112, 230), "HF": (1, 111), "HG": (3, 117), "HH": (118, 224),
    "HI": (3, 103), "HJ": (104, 224),
}


def bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    """MSB-first bit pairs -> dibit values (inverse of the RX bit unpacker)."""
    bits = np.asarray(bits, np.uint8)
    assert len(bits) % 2 == 0
    return (bits[0::2] << 1) | bits[1::2]


def sum_phase(bits: np.ndarray) -> int:
    """Cumulative phase (pi/4 units) of a dibit stream (tetra_burst.c:133-160)."""
    return int(DIBIT_TO_PHASE[bits_to_dibits(bits)].sum())


def phase_adj_bits(burst: np.ndarray, which: str) -> np.ndarray:
    """Compute the 2 phase-adjustment bits for range `which`.

    The adjustment symbol cancels the summed phase of symbols n1..n2 modulo
    2*pi so each burst is phase-neutral.
    """
    n1, n2 = PHASE_ADJ_RANGES[which]
    seg = burst[2 * (n1 - 1): 2 * n2]
    adj = -(sum_phase(seg) % 8)
    if adj > 3:
        adj -= 8
    elif adj < -3:
        adj += 8
    if adj not in _PHASE_TO_BITS:  # adj in {-2,0,2}: cannot happen for odd sums
        # every symbol contributes an odd phase count, and n2-n1+1 is odd
        raise ValueError(f"non-representable phase adjustment {adj}")
    return np.array(_PHASE_TO_BITS[adj], np.uint8)


def build_sync_burst(sb1_type5: np.ndarray, bbk_type5: np.ndarray,
                     sb2_type5: np.ndarray) -> np.ndarray:
    """Synchronization continuous downlink burst (510 bits).

    Layout (tetra_burst.c:171-217): q11..q22 | hc | freq-corr | SB1(120) |
    y(38) | BBK(30) | SB2(216) | hd | q1..q10.
    """
    assert len(sb1_type5) == 120 and len(bbk_type5) == 30 and len(sb2_type5) == 216
    burst = np.zeros(510, np.uint8)
    burst[0:12] = P.TRAIN_Q[10:22]
    # burst[12:14] = hc, filled below
    burst[14:94] = P.FREQ_CORR
    burst[94:214] = sb1_type5
    burst[214:252] = P.TRAIN_Y
    burst[252:282] = bbk_type5
    burst[282:498] = sb2_type5
    # burst[498:500] = hd, filled below
    burst[500:510] = P.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HC")
    burst[498:500] = phase_adj_bits(burst, "HD")
    return burst


def build_norm_burst(bkn1_type5: np.ndarray, bbk_type5: np.ndarray,
                     bkn2_type5: np.ndarray, two_log_chan: bool) -> np.ndarray:
    """Normal continuous downlink burst (510 bits).

    Layout (tetra_burst.c:220-269): q11..q22 | ha | BKN1(216) | bb(1..14) |
    n or p train(22) | bb(15..30) | BKN2(216) | hb | q1..q10.
    """
    assert len(bkn1_type5) == 216 and len(bbk_type5) == 30 and len(bkn2_type5) == 216
    burst = np.zeros(510, np.uint8)
    burst[0:12] = P.TRAIN_Q[10:22]
    # burst[12:14] = ha
    burst[14:230] = bkn1_type5
    burst[230:244] = bbk_type5[:14]
    burst[244:266] = P.TRAIN_P if two_log_chan else P.TRAIN_N
    burst[266:282] = bbk_type5[14:30]
    burst[282:498] = bkn2_type5
    # burst[498:500] = hb
    burst[500:510] = P.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HA")
    burst[498:500] = phase_adj_bits(burst, "HB")
    return burst
