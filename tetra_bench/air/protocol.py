"""TETRA protocol constants the air generator and the reference use,
frozen as numbers (ETSI EN 300 392-2: clause 8.2 block coding, clause 9.4
bursts and training sequences, clause 7.3 TDMA timing).

A frozen copy: nothing here is imported from the system under test, so a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

SYMBOL_RATE = 18_000            # pi/4-DQPSK symbols per second
SAMPLE_RATE = 36_000            # 2 samples per symbol at the shaping filter
SYM_PER_TS = 255
BITS_PER_TS = 510
SLOTS_PER_MULTIFRAME = 72       # 18 frames of 4 timeslots
CHANNEL_HZ = 25_000

# phase step of dibit d = b0 << 1 | b1, in units of pi/4 (table 9.14)
DIBIT_STEP = np.array([1, 3, -1, -3], np.int64)

TRAIN_N = np.array([1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1,
                    0, 1, 0, 0], np.uint8)
TRAIN_P = np.array([0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1,
                    1, 1, 1, 0], np.uint8)
TRAIN_Q = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0,
                    1, 1, 0, 1], np.uint8)
TRAIN_Y = np.array([1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1,
                    1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1,
                    1, 1], np.uint8)
FREQ_CORR = np.concatenate([np.ones(8, np.uint8), np.zeros(64, np.uint8),
                            np.ones(8, np.uint8)])

# block types (TP-SAP) and the engine's block numbers within a burst
T_SB1, T_SB2, T_NDB, T_BBK = 0, 1, 2, 3
# name: type-5 bits, type-2 bits, type-1 bits, interleaver a
BLOCKS = {T_SB1: (120, 80, 60, 11), T_SB2: (216, 144, 124, 101),
          T_NDB: (216, 144, 124, 101), T_BBK: (30, 30, 14, 0)}

SCRAMB_TAPS = (32, 26, 23, 22, 16, 12, 11, 10, 8, 7, 5, 4, 2, 1)
SCRAMB_INIT = 3

# rate-1/4 K=5 mother code, taps over [x_n .. x_{n-4}]
CONV_POLYS = np.array([[1, 1, 0, 0, 1], [1, 0, 1, 1, 1], [1, 1, 1, 0, 1],
                       [1, 1, 0, 1, 1]], np.uint8)
# rate-2/3 puncturer of clause 8.2.3.1.3: P(1..3) = 1, 2, 5 of period 8
PUNCT_2_3 = ((0, 1, 2, 5), 3, 8)

CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF

RM3014_PARITY = np.array([
    [1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0],
    [1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0],
    [0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1],
    [0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1],
    [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1],
    [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1]], np.uint8)

# the transmit shaping filter: root-raised cosine, 65 taps at 2 samples
# per symbol, roll-off 0.35 (the receiver's matched filter is its twin)
RRC_TAPS = 65
RRC_ALPHA = 0.35


def scramb_init(mcc: int, mnc: int, cc: int) -> int:
    """Cell scrambling-sequence initialiser (clause 8.2.5.2)."""
    return (((cc & 0x3F) | ((mnc & 0x3FFF) << 6) | ((mcc & 0x3FF) << 20))
            << 2) | SCRAMB_INIT


def rrc_taps(count: int = RRC_TAPS, beta: float = RRC_ALPHA,
             sps: float = 2.0) -> np.ndarray:
    """Root-raised-cosine impulse response, unit DC gain, float64, taps at
    t = (k - (count-1)/2) / sps symbol periods."""
    t = (np.arange(count) - (count - 1) / 2.0) / sps
    h = np.empty(count)
    eps = 1e-9
    t0 = np.abs(t) < eps
    ts = np.abs(np.abs(t) - 1.0 / (4.0 * beta)) < eps
    reg = ~(t0 | ts)
    tr = t[reg]
    h[reg] = (np.sin(np.pi * tr * (1 - beta))
              + 4 * beta * tr * np.cos(np.pi * tr * (1 + beta))) / (
        np.pi * tr * (1 - (4 * beta * tr) ** 2))
    h[t0] = 1.0 - beta + 4.0 * beta / np.pi
    h[ts] = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    return h / h.sum()
