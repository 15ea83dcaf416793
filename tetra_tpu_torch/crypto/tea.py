"""TETRA TEA1/TEA2/TEA3 keystream generators.

The cipher structures and constant tables are the published results of the
Midnight Blue "TETRA:BURST" disclosure (also carried by the reference at
crypto/tea1.c, tea2.c, tea3.c).  All three share a design: an 80-bit key
register with nonlinear S-box feedback, a 64-bit IV register clocked 54/51
initialization rounds then 19 rounds per output byte, two LUT-driven
state-word filters and one bit-reorder filter mixed into the register feed.

These run per-slot at ~kHz rates on the host (keystream generation is a few
thousand byte operations per timeslot); a vectorized batch variant for bulk
scanning can sit on device later without changing this API.
"""

from __future__ import annotations

from .tea_tables import (TEA1_LUTA as _TEA1_LUT_A,
                         TEA1_LUTB as _TEA1_LUT_B, TEA1_SBOX as _TEA1_SBOX,
                         TEA2_LUTA as _TEA2_LUT_A, TEA2_LUTB as _TEA2_LUT_B,
                         TEA2_SBOX as _TEA2_SBOX, TEA3_LUTA as _TEA3_LUT_A,
                         TEA3_LUTB as _TEA3_LUT_B, TEA3_SBOX as _TEA3_SBOX)


def _rotr8(b: int) -> int:
    return ((b >> 1) | (b << 7)) & 0xFF


def _expand_iv(iv32: int, whiten: int) -> int:
    """64-bit IV register from the 29-bit frame-number IV."""
    x = (iv32 ^ whiten) & 0xFFFFFFFF
    x = ((x << 8) | (x >> 24)) & 0xFFFFFFFF
    q = ((iv32 & 0xFFFFFFFF) << 32) | x
    return ((q >> 8) | (q << 56)) & 0xFFFFFFFFFFFFFFFF


def _word_filter(w: int, lut: tuple, tap_fn) -> int:
    """8 rotations of the two state bytes; each picks one LUT bit by the
    4-bit tap distance tap_fn(b0, b1)."""
    b0, b1 = w & 0xFF, (w >> 8) & 0xFF
    out = 0
    for i in range(8):
        dist = tap_fn(b0, b1)
        if lut[i] & (1 << dist):
            out |= 1 << i
        b0, b1 = _rotr8(b0), _rotr8(b1)
    return out


def _tea1_taps(b0: int, b1: int) -> int:
    return ((b0 >> 7) & 1) | ((b0 << 1) & 2) | ((b1 << 1) & 12)


def _tea2_taps(b0: int, b1: int) -> int:
    return (((b0 >> 1) & 0x1) | ((b0 >> 1) & 0x2)
            | ((b1 >> 5) & 0x4) | ((b1 << 3) & 0x8))


def _tea3_taps(b0: int, b1: int) -> int:
    return ((b0 >> 5) & 3) | ((b1 >> 3) & 12)


def _tea1_reorder(b: int) -> int:
    return (((b << 6) & 0x40) | ((b << 1) & 0x20) | ((b << 2) & 0x08)
            | ((b >> 3) & 0x14) | ((b >> 2) & 0x01) | ((b >> 5) & 0x02)
            | ((b << 4) & 0x80)) & 0xFF


def _tea2_reorder(b: int) -> int:
    return (((b << 6) & 0x40) | ((b << 3) & 0x10) | ((b >> 2) & 0x01)
            | ((b << 2) & 0x20) | ((b << 3) & 0x80) | ((b >> 4) & 0x02)
            | ((b >> 3) & 0x08) | ((b >> 5) & 0x04)) & 0xFF


def _tea3_reorder(b: int) -> int:
    return (((b << 6) & 0x40) | ((b << 1) & 0x20) | ((b << 2) & 0x98)
            | ((b >> 4) & 0x04) | ((b >> 3) & 0x01) | ((b >> 6) & 0x02)) & 0xFF


def tea1(iv32: int, key: bytes, n_bytes: int) -> bytes:
    """TEA1 keystream: 32-bit key register with S-box feedback."""
    iv = _expand_iv(iv32, 0x96724FA1)
    kreg = 0
    for i in range(10):
        kreg = ((kreg << 8) & 0xFFFFFFFF) | _TEA1_SBOX[
            ((kreg >> 24) ^ key[i] ^ kreg) & 0xFF]
    out = bytearray()
    rounds = 54
    for _ in range(n_bytes):
        for _ in range(rounds):
            sbox_out = _TEA1_SBOX[((kreg >> 24) ^ kreg) & 0xFF]
            kreg = ((kreg << 8) & 0xFFFFFFFF) | sbox_out
            d12 = _word_filter((iv >> 8) & 0xFFFF, _TEA1_LUT_A, _tea1_taps)
            d56 = _word_filter((iv >> 40) & 0xFFFF, _TEA1_LUT_B, _tea1_taps)
            r4 = _tea1_reorder((iv >> 32) & 0xFF)
            newbyte = (d56 ^ (iv >> 56) ^ r4 ^ sbox_out) & 0xFF
            iv = (((iv << 8) ^ (d12 << 32)) | newbyte) & 0xFFFFFFFFFFFFFFFF
        out.append(iv >> 56)
        rounds = 19
    return bytes(out)


def _tea23(iv32: int, key: bytes, n_bytes: int, whiten: int, sbox,
           lut_a, lut_b, taps, reorder, feedback) -> bytes:
    iv = _expand_iv(iv32, whiten)
    kreg = bytearray(key[:10])
    out = bytearray()
    rounds = 51
    for _ in range(n_bytes):
        for _ in range(rounds):
            sbox_out = feedback(kreg, sbox)
            kreg = kreg[1:] + bytes([sbox_out])
            if whiten == 0x5A6E3278:  # TEA2 register geometry
                d01 = _word_filter(iv & 0xFFFF, lut_a, taps)
                d34 = _word_filter((iv >> 24) & 0xFFFF, lut_b, taps)
                r5 = reorder((iv >> 40) & 0xFF)
                newbyte = ((iv >> 56) ^ (iv >> 16) ^ r5 ^ d01 ^ sbox_out) & 0xFF
                iv = (((iv << 8) ^ (d34 << 24)) | newbyte) & 0xFFFFFFFFFFFFFFFF
            else:  # TEA3 register geometry
                d12 = _word_filter((iv >> 8) & 0xFFFF, lut_a, taps)
                d56 = _word_filter((iv >> 40) & 0xFFFF, lut_b, taps)
                r4 = reorder((iv >> 32) & 0xFF)
                newbyte = ((iv >> 56) ^ r4 ^ d12 ^ sbox_out) & 0xFF
                iv = (((iv << 8) ^ (d56 << 40)) | newbyte) & 0xFFFFFFFFFFFFFFFF
        out.append(iv >> 56)
        rounds = 19
    return bytes(out)


def tea2(iv32: int, key: bytes, n_bytes: int) -> bytes:
    return _tea23(iv32, key, n_bytes, 0x5A6E3278, _TEA2_SBOX,
                  _TEA2_LUT_A, _TEA2_LUT_B, _tea2_taps, _tea2_reorder,
                  lambda kreg, sbox: sbox[kreg[0] ^ kreg[7]])


def tea3(iv32: int, key: bytes, n_bytes: int) -> bytes:
    return _tea23(iv32, key, n_bytes, 0xC43A7D51, _TEA3_SBOX,
                  _TEA3_LUT_A, _TEA3_LUT_B, _tea3_taps, _tea3_reorder,
                  lambda kreg, sbox: sbox[kreg[7] ^ kreg[2]] ^ kreg[0])


KSG_FUNCS = {1: tea1, 2: tea2, 3: tea3}
