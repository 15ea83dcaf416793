"""TETRA speech channel coding for the benchmark's air (ETSI EN 300 395-2
clause 5, the conventions of the program's TX fixture), frozen in plain
NumPy: two 137-bit ACELP frames -> 432 type-3 bits of a traffic slot, and
one frame -> the 216 bits of the half block that survives a first-half
steal.

Full slot: class 0 (2 x 51 bits) unprotected; class 1 (2 x 56) through
the rate-1/3 K=5 mother code punctured 8/12 to 168; class 2 (2 x 30) with
an 8-bit CRC (X^8+X^4+X^3+X^2+1, init 0) and 4 tail bits punctured 8/18
to 162; [c0 | c1 | c2] matrix-interleaved 24 lines x 18 columns.  Half
block: 51 + 84 (8/12) + 80 (30 bits, a 4-bit CRC X^4+X+1, 4 tail, 8/17)
+ 1 fill, interleaved 12 x 18.  Classes are taken from the codec frame by
the reordering tables below (EN 300 395-2 table 4, with the class-0 table
made a partition as the program makes it).

A frozen copy: nothing here is imported from the system under test.
"""

from __future__ import annotations

import numpy as np

FRAME_BITS = 137
# the speech mother code, taps over [x_n .. x_{n-4}]
TCH_POLYS = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 1, 1], [1, 0, 1, 0, 1]],
                     np.uint8)
# (P table, t, period) of clause 8.2.3.1.2's k = period*floor((i-1)/t) +
# P[i - t*floor((i-1)/t)]
PUNCT_8_12 = ((0, 1, 2, 4), 3, 6)
PUNCT_8_18 = ((0, 1, 2, 3, 4, 5, 7, 8, 10, 11), 9, 12)
PUNCT_8_17 = ((0, 1, 2, 3, 4, 5, 7, 8, 10, 11, 13, 14, 16, 17, 19, 20, 22,
               23), 17, 24)
CRC8_POLY, CRC4_POLY = 0x1D, 0x3

# codec-frame positions (1-based) of each class
CLASS0 = np.array([
    35, 36, 37, 38, 39, 40, 41, 42, 47, 48, 56, 61, 62, 63, 65, 66, 67,
    68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 101, 102,
    110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 128, 129, 137,
    43, 64], np.int64)
CLASS1 = np.array([
    58, 85, 112, 54, 81, 108, 135, 50, 77, 104, 131, 45, 72, 99, 126, 55, 82,
    109, 136, 5, 13, 34, 8, 16, 17, 22, 23, 24, 25, 26, 6, 14, 7, 15, 60, 87,
    114, 46, 73, 100, 127, 44, 71, 98, 125, 33, 49, 76, 103, 130, 59, 86,
    113, 57, 84, 111], np.int64)
CLASS2 = np.array([
    18, 19, 20, 21, 31, 32, 53, 80, 107, 134, 1, 2, 3, 4, 9, 10, 11, 12, 27,
    28, 29, 30, 52, 79, 106, 133, 51, 78, 105, 132], np.int64)


def _conv(bits: np.ndarray) -> np.ndarray:
    n_out, K = TCH_POLYS.shape
    hist = np.zeros((K, len(bits)), np.int32)
    for d in range(K):
        hist[d, d:] = bits[:len(bits) - d]
    return ((TCH_POLYS.astype(np.int32) @ hist) % 2).T.reshape(-1) \
        .astype(np.uint8)


def _puncture(mother: np.ndarray, punct: tuple, out_len: int) -> np.ndarray:
    pt, t, period = punct
    j = np.arange(1, out_len + 1)
    blk = (j - 1) // t
    return mother[period * blk + np.asarray(pt)[j - t * blk] - 1]


def _crc(bits: np.ndarray, n: int, poly: int) -> np.ndarray:
    top, mask = 1 << (n - 1), (1 << n) - 1
    crc = 0
    for b in bits:
        crc ^= int(b) << (n - 1)
        crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return np.array([(crc >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _interleave_perm(lines: int, columns: int) -> np.ndarray:
    """interleaved[i*lines + j] = type3[j*columns + i]."""
    i, j = np.meshgrid(np.arange(columns), np.arange(lines), indexing="ij")
    out = np.empty(lines * columns, np.int64)
    out[(i * lines + j).reshape(-1)] = (j * columns + i).reshape(-1)
    return out


_PERM_SLOT = _interleave_perm(24, 18)
_PERM_HALF = _interleave_perm(12, 18)


def encode_slot(frames: np.ndarray) -> np.ndarray:
    """Two 137-bit codec frames -> 432 type-3 bits of a traffic slot."""
    f = np.asarray(frames, np.uint8).reshape(2, FRAME_BITS)
    c0, c1, c2 = (np.stack([f[0, t - 1], f[1, t - 1]], axis=1).reshape(-1)
                  for t in (CLASS0, CLASS1, CLASS2))
    c1_coded = _puncture(_conv(c1), PUNCT_8_12, 168)
    c2_blk = np.concatenate([c2, _crc(c2, 8, CRC8_POLY),
                             np.zeros(4, np.uint8)])
    c2_coded = _puncture(_conv(c2_blk), PUNCT_8_18, 162)
    return np.concatenate([c0, c1_coded, c2_coded])[_PERM_SLOT]


def encode_half_slot(frame: np.ndarray) -> np.ndarray:
    """One 137-bit codec frame -> 216 type-3 bits of a half block."""
    f = np.asarray(frame, np.uint8)
    c0, c1, c2 = (f[t - 1] for t in (CLASS0, CLASS1, CLASS2))
    c1_coded = _puncture(_conv(c1), PUNCT_8_12, 84)
    c2_blk = np.concatenate([c2, _crc(c2, 4, CRC4_POLY),
                             np.zeros(4, np.uint8)])
    c2_coded = _puncture(_conv(c2_blk), PUNCT_8_17, 80)
    return np.concatenate([c0, c1_coded, c2_coded,
                           np.zeros(1, np.uint8)])[_PERM_HALF]
