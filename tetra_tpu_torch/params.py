"""TETRA protocol constants (ETSI EN 300 392-2 V3.2.1).

Single source of truth for every protocol-level magic number used by both the
TX (golden fixture / modulator) chain and the RX (demod / decode) chain.

All values are protocol facts from the ETSI standard (a copy of
tetra_tpu/params.py, so the port imports nothing of the JAX package).
Reference-parity citations point at cropinghigh/sdrpp-tetra-demodulator:
  - burst structure:      phy/tetra_burst.c:33-117
  - block FEC params:     lower_mac/tetra_lower_mac.c:58-105
  - scrambler taps:       lower_mac/tetra_scramb.c:39-43
  - puncture tables:      lower_mac/tetra_conv_enc.c:99-105
  - mother-code polys:    lower_mac/viterbi_cch.c:29-34, viterbi_tch.c:29-33
  - CRC:                  lower_mac/crc_simple.c (poly 0x1021), residue
                          tetra_common.h:330 (0x1d0f)
  - RM(30,14) generator:  lower_mac/tetra_rm3014.c:28-44
  - TDMA frame structure: tetra_common.h:237-238
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Modulation / timing
# ---------------------------------------------------------------------------

SYMBOL_RATE = 18_000            # pi/4-DQPSK symbols per second
SAMPLE_RATE = 36_000            # reference VFO sample rate (2 samples/symbol)
BITS_PER_SYMBOL = 2
SYM_PER_TS = 255                # symbols per timeslot
BITS_PER_TS = SYM_PER_TS * BITS_PER_SYMBOL   # 510
TS_PER_FRAME = 4
FRAMES_PER_MULTIFRAME = 18
MULTIFRAMES_PER_HYPERFRAME = 60

# Offset (in bits within a 510-bit slot) where the training sequence of each
# burst type is expected when the receiver is slot-aligned
# (phy/tetra_burst_sync.c:123,133).
SYNC_TRAIN_OFFSET = 214
NORM_TRAIN_OFFSET = 244
# After finding a SYNC training sequence at bit offset k, the next slot starts
# at k + 296 (phy/tetra_burst_sync.c:81).
SYNC_TRAIN_TO_NEXT_SLOT = 296

# ---------------------------------------------------------------------------
# Training sequences (ETSI 9.4.4.3.2-4)
# ---------------------------------------------------------------------------

# Normal training sequences (22 bits)
TRAIN_N = np.array([1,1, 0,1, 0,0, 0,0, 1,1, 1,0, 1,0, 0,1, 1,1, 0,1, 0,0], np.uint8)
TRAIN_P = np.array([0,1, 1,1, 1,0, 1,0, 0,1, 0,0, 0,0, 1,1, 0,1, 1,1, 1,0], np.uint8)
TRAIN_Q = np.array([1,0, 1,1, 0,1, 1,1, 0,0, 0,0, 0,1, 1,0, 1,0, 1,1, 0,1], np.uint8)
# Synchronisation training sequence (38 bits)
TRAIN_Y = np.array([1,1, 0,0, 0,0, 0,1, 1,0, 0,1, 1,1, 0,0, 1,1, 1,0, 1,0,
                    0,1, 1,1, 0,0, 0,0, 0,1, 1,0, 0,1, 1,1], np.uint8)
# Extended training sequence (30 bits) - uplink, recognised but ignored on DL
TRAIN_X = np.array([1,0, 0,1, 1,1, 0,1, 0,0, 0,0, 1,1, 1,0, 1,0, 0,1, 1,1,
                    0,1, 0,0, 0,0, 1,1], np.uint8)
# Extended 45-bit sequence (ETSI 9.4.4.3.3, used by the reference's mode-1
# training-sequence monitor, main.cpp:456-468)
TRAIN_X45 = np.array([0,1,1,1,0,0,1,1,0,1,0,0,0,0,1,0,0,0,1,1,1,0,1,1,0,1,
                      0,1,0,1,1,1,1,1,0,1,0,0,0,0,0,1,1,1,0], np.uint8)
# 33-bit sequences used by the mode-1 monitor
TRAIN_N33 = np.array([1,1,1, 0,0,1, 1,0,1, 1,1,1, 0,0,0, 1,1,1, 1,0,0, 0,1,1,
                      1,1,0, 0,0,0, 0,0,0], np.uint8)
TRAIN_P33 = np.array([1,0,1, 0,1,1, 1,1,1, 1,0,1, 0,1,0, 1,0,1, 1,1,0, 0,0,1,
                      1,0,0, 0,1,0, 0,1,0], np.uint8)

# Frequency-correction field (80 bits: 8 ones, 64 zeros, 8 ones; 9.4.4.3.1)
FREQ_CORR = np.zeros(80, np.uint8)
FREQ_CORR[:8] = 1
FREQ_CORR[72:] = 1

# Tail bits (9.4.4.3.5)
TAIL_T = np.array([1, 1, 0, 0], np.uint8)
TAIL_T6 = np.array([1, 1, 1, 0, 0, 0], np.uint8)

# Training sequence identifiers (mirror of enum tetra_train_seq)
TRAIN_SEQ_NORM_1 = 0   # n
TRAIN_SEQ_NORM_2 = 1   # p
TRAIN_SEQ_NORM_3 = 2   # q
TRAIN_SEQ_SYNC = 3     # y
TRAIN_SEQ_EXT = 4      # x

TRAIN_SEQS = {
    TRAIN_SEQ_NORM_1: TRAIN_N,
    TRAIN_SEQ_NORM_2: TRAIN_P,
    TRAIN_SEQ_NORM_3: TRAIN_Q,
    TRAIN_SEQ_SYNC: TRAIN_Y,
    TRAIN_SEQ_EXT: TRAIN_X,
}

# ---------------------------------------------------------------------------
# Burst field layout, downlink continuous bursts (9.4.4.2.5/9.4.4.2.6)
# Offsets/lengths in bits within a 510-bit slot (phy/tetra_burst.c:33-49).
# ---------------------------------------------------------------------------

SB_BLK1_OFFSET = (6 + 1 + 40) * 2          # 94  : SB1 scrambled block 1
SB_BBK_OFFSET = (6 + 1 + 40 + 60 + 19) * 2  # 252 : SB broadcast block
SB_BLK2_OFFSET = (6 + 1 + 40 + 60 + 19 + 15) * 2  # 282 : SB block 2
SB_BLK1_BITS = 120
SB_BBK_BITS = 30
SB_BLK2_BITS = 216

NDB_BLK1_OFFSET = (5 + 1 + 1) * 2               # 14
NDB_BBK1_OFFSET = (5 + 1 + 1 + 108) * 2         # 230
NDB_BBK2_OFFSET = (5 + 1 + 1 + 108 + 7 + 11) * 2  # 266
NDB_BLK2_OFFSET = (5 + 1 + 1 + 108 + 7 + 11 + 8) * 2  # 282
NDB_BBK1_BITS = 14
NDB_BBK2_BITS = 16
NDB_BLK_BITS = 216
NDB_BBK_BITS = 30

# ---------------------------------------------------------------------------
# Lower-MAC block FEC parameters (tetra_lower_mac.c:58-105)
# ---------------------------------------------------------------------------

# TP-SAP block types (mirror of enum tp_sap_data_type)
TPSAP_T_SB1 = 0
TPSAP_T_SB2 = 1
TPSAP_T_NDB = 2
TPSAP_T_BBK = 3
TPSAP_T_SCH_HU = 4
TPSAP_T_SCH_F = 5

BLK_PARAMS = {
    # name, type345 bits, type2 bits, type1 bits, interleave a, has crc16
    TPSAP_T_SB1:    ("SB1",    120, 80, 60, 11, True),
    TPSAP_T_SB2:    ("SB2",    216, 144, 124, 101, True),
    TPSAP_T_NDB:    ("NDB",    216, 144, 124, 101, True),
    TPSAP_T_SCH_HU: ("SCH/HU", 168, 112, 92, 13, True),
    TPSAP_T_SCH_F:  ("SCH/F",  432, 288, 268, 103, True),
    TPSAP_T_BBK:    ("BBK",    30, 30, 14, 0, False),
}

# ---------------------------------------------------------------------------
# Scrambler (8.2.5; tetra_scramb.c)
# ---------------------------------------------------------------------------

# Fibonacci LFSR tap positions (1-indexed from the standard)
SCRAMB_TAPS = (32, 26, 23, 22, 16, 12, 11, 10, 8, 7, 5, 4, 2, 1)
SCRAMB_INIT = 3  # p(0)=p(-1)=1 -> low 2 bits set; SB1 always uses this


def scramb_get_init(mcc: int, mnc: int, colour: int) -> int:
    """Cell scrambling-sequence initializer (tetra_scramb.c:87-99)."""
    mcc &= 0x3FF
    mnc &= 0x3FFF
    colour &= 0x3F
    return ((colour | (mnc << 6) | (mcc << 20)) << 2) | SCRAMB_INIT


# ---------------------------------------------------------------------------
# Mother codes (8.2.3.1.1 data; EN 300 395-2 5.5.1 speech)
# ---------------------------------------------------------------------------

# Rate-1/4 K=5 data mother code generator polynomials, taps over
# [current, D, D2, D3, D4]:
#   G1 = 1 + D + D4, G2 = 1 + D2 + D3 + D4, G3 = 1 + D + D2 + D4,
#   G4 = 1 + D + D3 + D4
CONV_CCH_POLYS = np.array(
    [
        [1, 1, 0, 0, 1],
        [1, 0, 1, 1, 1],
        [1, 1, 1, 0, 1],
        [1, 1, 0, 1, 1],
    ],
    np.uint8,
)

# Rate-1/3 K=5 speech mother code:
#   G1 = 1 + D + D2 + D3 + D4, G2 = 1 + D + D3 + D4, G3 = 1 + D2 + D4
CONV_TCH_POLYS = np.array(
    [
        [1, 1, 1, 1, 1],
        [1, 1, 0, 1, 1],
        [1, 0, 1, 0, 1],
    ],
    np.uint8,
)

# ---------------------------------------------------------------------------
# RCPC puncturing (8.2.3.1.2-6; EN 300 395-2 5.5.2/5.6.2)
# ---------------------------------------------------------------------------

PUNCT_2_3 = 0
PUNCT_1_3 = 1
PUNCT_292_432 = 2
PUNCT_148_432 = 3
PUNCT_112_168 = 4
PUNCT_72_162 = 5
PUNCT_38_80 = 6

# (P table, t, period, i_func)  where i_func maps 1-based j -> i
_PUNCT_IDENT = lambda j: j
_PUNCT_292 = lambda j: j + (j - 1) // 65
_PUNCT_148 = lambda j: j + (j - 1) // 35

PUNCTURERS = {
    PUNCT_2_3:     ((0, 1, 2, 5), 3, 8, _PUNCT_IDENT),
    PUNCT_1_3:     ((0, 1, 2, 3, 5, 6, 7), 6, 8, _PUNCT_IDENT),
    PUNCT_292_432: ((0, 1, 2, 5), 3, 8, _PUNCT_292),
    PUNCT_148_432: ((0, 1, 2, 3, 5, 6, 7), 6, 8, _PUNCT_148),
    PUNCT_112_168: ((0, 1, 2, 4), 3, 6, _PUNCT_IDENT),
    PUNCT_72_162:  ((0, 1, 2, 3, 4, 5, 7, 8, 10, 11), 9, 12, _PUNCT_IDENT),
    PUNCT_38_80:   ((0, 1, 2, 3, 4, 5, 7, 8, 10, 11, 13, 14, 16, 17, 19, 20,
                     22, 23), 17, 24, _PUNCT_IDENT),
}


def puncture_indices(punct_id: int, out_len: int) -> np.ndarray:
    """0-based indices into the mother stream selected by a puncturer.

    Implements the k = period*floor((i-1)/t) + P[i - t*floor((i-1)/t)] rule of
    clause 8.2.3.1.2 (semantics of lower_mac/tetra_conv_enc.c:229-251).
    Returns an int32 array idx with mother[idx[j]] == type3[j].
    """
    P, t, period, i_func = PUNCTURERS[punct_id]
    idx = np.empty(out_len, np.int32)
    for j in range(1, out_len + 1):
        i = i_func(j)
        blk = (i - 1) // t
        k = period * blk + P[i - t * blk]
        idx[j - 1] = k - 1
    return idx


# ---------------------------------------------------------------------------
# Block interleaver (8.2.4.1): k(i) = 1 + (a*i mod K), 1-based
# ---------------------------------------------------------------------------

def interleave_indices(K: int, a: int) -> np.ndarray:
    """0-based permutation: interleaved[k[i]] = in[i] (tetra_interleave.c:36-59)."""
    i = np.arange(1, K + 1, dtype=np.int64)
    k = 1 + (a * i) % K
    return (k - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# CRC-16 (X.25 / ITU-T, poly 0x1021, init 0xffff, good residue 0x1d0f)
# ---------------------------------------------------------------------------

CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
CRC16_GOOD = 0x1D0F

# ---------------------------------------------------------------------------
# RM(30,14) shortened Reed-Muller generator (8.2.3.2; tetra_rm3014.c:28-44)
# Parity part only; full generator is [I_14 | RM3014_PARITY].
# ---------------------------------------------------------------------------

RM3014_PARITY = np.array(
    [
        [1,0,0,1,1,0,1,1,0,1,1,0,0,0,0,0],
        [0,0,1,0,1,1,0,1,1,1,1,0,0,0,0,0],
        [1,1,1,1,1,1,0,0,0,0,1,0,0,0,0,0],
        [1,1,1,0,0,0,0,0,0,0,1,1,1,1,0,0],
        [1,0,0,1,1,0,0,0,0,0,1,1,1,0,1,0],
        [0,1,0,1,0,1,0,0,0,0,1,1,0,1,1,0],
        [0,0,1,0,1,1,0,0,0,0,1,0,1,1,1,0],
        [1,1,1,1,1,1,1,1,1,1,0,1,1,1,1,1],
        [1,0,0,0,0,0,1,1,0,0,1,1,1,0,0,1],
        [0,1,0,0,0,0,1,0,1,0,1,1,0,1,0,1],
        [0,0,1,0,0,0,0,1,1,0,1,0,1,1,0,1],
        [0,0,0,1,0,0,1,0,0,1,1,1,0,0,1,1],
        [0,0,0,0,1,0,0,1,0,1,1,0,1,0,1,1],
        [0,0,0,0,0,1,0,0,1,1,1,0,0,1,1,1],
    ],
    np.uint8,
)

# ---------------------------------------------------------------------------
# Demodulator tuning constants (reference main.cpp:35-44)
# ---------------------------------------------------------------------------

RRC_TAP_COUNT = 65
RRC_ALPHA = 0.35
AGC_RATE = 0.02
AGC_SETPOINT = 1.0
AGC_MAX_GAIN = 10e6
COSTAS_LOOP_BANDWIDTH = 0.01
FLL_LOOP_BANDWIDTH = 0.006
CLOCK_RECOVERY_BW = 0.00628
CLOCK_RECOVERY_DAMPING = 0.707
CLOCK_RECOVERY_REL_LIMIT = 0.02
INTERP_PHASE_COUNT = 128
INTERP_TAP_COUNT = 8

# Symbol-quality gate (dqpsk_sym_extr.cpp:14-15,25)
SYNC_DETECT_BUF = 4096
SYNC_DETECT_DISPLAY = 256
SYNC_QUALITY_THRESHOLD = 0.35

# Channel raster
CHANNEL_SPACING_HZ = 25_000
