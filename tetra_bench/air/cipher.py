"""TETRA air-interface encryption for the benchmark's air, frozen as
numbers and run over many IVs at once in NumPy: TEA1's keystream (ETSI EN
300 392-7; the cipher's structure and tables as published by the
TETRA:BURST disclosure), the 29-bit IV from TDMA time, the TB5 key
derivation, and the text keystore a receiver loads (one `network` and one
`key` line a network).

A frozen copy: nothing here is imported from the system under test.  The
keystream is the byte-serial generator's, bit for bit; TEA1's key register
evolves from the key alone, so it runs once a key while the 64-bit IV
registers of every slot advance together, their two 16-bit word filters
and their bit reorder read from tables of every input.
"""

from __future__ import annotations

import numpy as np

KSG_TEA1 = 1            # the keystore's ksg_type of TEA1
KEYTYPE_CCK_SCK = 1     # the keystore's key_type of a common cipher key
SECURITY_CLASS = 2      # class 2: static cipher keys

LUT_A = (0xda86, 0x85e9, 0x29b5, 0x2bc6, 0x8c6b, 0x974c, 0xc671, 0x93e2)
LUT_B = (0x85d6, 0x791a, 0xe985, 0xc671, 0x2b9c, 0xec92, 0xc62b, 0x9c47)
SBOX = np.array([
    0x9B, 0xF8, 0x3B, 0x72, 0x75, 0x62, 0x88, 0x22, 0xFF, 0xA6, 0x10, 0x4D,
    0xA9, 0x97, 0xC3, 0x7B, 0x9F, 0x78, 0xF3, 0xB6, 0xA0, 0xCC, 0x17, 0xAB,
    0x4A, 0x41, 0x8D, 0x89, 0x25, 0x87, 0xD3, 0xE3, 0xCE, 0x47, 0x35, 0x2C,
    0x6D, 0xFC, 0xE7, 0x6A, 0xB8, 0xB7, 0xFA, 0x8B, 0xCD, 0x74, 0xEE, 0x11,
    0x23, 0xDE, 0x39, 0x6C, 0x1E, 0x8E, 0xED, 0x30, 0x73, 0xBE, 0xBB, 0x91,
    0xCA, 0x69, 0x60, 0x49, 0x5F, 0xB9, 0xC0, 0x06, 0x34, 0x2A, 0x63, 0x4B,
    0x90, 0x28, 0xAC, 0x50, 0xE4, 0x6F, 0x36, 0xB0, 0xA4, 0xD2, 0xD4, 0x96,
    0xD5, 0xC9, 0x66, 0x45, 0xC5, 0x55, 0xDD, 0xB2, 0xA1, 0xA8, 0xBF, 0x37,
    0x32, 0x2B, 0x3E, 0xB5, 0x5C, 0x54, 0x67, 0x92, 0x56, 0x4C, 0x20, 0x6B,
    0x42, 0x9D, 0xA7, 0x58, 0x0E, 0x52, 0x68, 0x95, 0x09, 0x7F, 0x59, 0x9C,
    0x65, 0xB1, 0x64, 0x5E, 0x4F, 0xBA, 0x81, 0x1C, 0xC2, 0x0C, 0x02, 0xB4,
    0x31, 0x5B, 0xFD, 0x1D, 0x0A, 0xC8, 0x19, 0x8F, 0x83, 0x8A, 0xCF, 0x33,
    0x9E, 0x3A, 0x80, 0xF2, 0xF9, 0x76, 0x26, 0x44, 0xF1, 0xE2, 0xC4, 0xF5,
    0xD6, 0x51, 0x46, 0x07, 0x14, 0x61, 0xF4, 0xC1, 0x24, 0x7A, 0x94, 0x27,
    0x00, 0xFB, 0x04, 0xDF, 0x1F, 0x93, 0x71, 0x53, 0xEA, 0xD8, 0xBD, 0x3D,
    0xD0, 0x79, 0xE6, 0x7E, 0x4E, 0x9A, 0xD7, 0x98, 0x1B, 0x05, 0xAE, 0x03,
    0xC7, 0xBC, 0x86, 0xDB, 0x84, 0xE8, 0xD1, 0xF7, 0x16, 0x21, 0x6E, 0xE5,
    0xCB, 0xA3, 0x1A, 0xEC, 0xA2, 0x7D, 0x18, 0x85, 0x48, 0xDA, 0xAA, 0xF0,
    0x08, 0xC6, 0x40, 0xAD, 0x57, 0x0D, 0x29, 0x82, 0x7C, 0xE9, 0x8C, 0xFE,
    0xDC, 0x0F, 0x2D, 0x3C, 0x2E, 0xF6, 0x15, 0x2F, 0xAF, 0xE1, 0xEB, 0x3F,
    0x99, 0x43, 0x13, 0x0B, 0xE0, 0xA5, 0x12, 0x77, 0x5D, 0xB3, 0x38, 0xD9,
    0xEF, 0x5A, 0x01, 0x70,
], np.uint64)
IV_WHITEN = 0x96724FA1
_M32, _M64 = 0xFFFFFFFF, np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotr8(b):
    return ((b >> 1) | (b << 7)) & 0xFF


def _filter_table(lut: tuple) -> np.ndarray:
    """The word filter of every 16-bit state word: 8 rotations of its two
    bytes, each picking one bit of lut[i] by the 4-bit tap distance."""
    w = np.arange(1 << 16, dtype=np.int64)
    b0, b1 = w & 0xFF, w >> 8
    out = np.zeros(1 << 16, np.int64)
    for i in range(8):
        dist = ((b0 >> 7) & 1) | ((b0 << 1) & 2) | ((b1 << 1) & 12)
        out |= ((lut[i] >> dist) & 1) << i
        b0, b1 = _rotr8(b0), _rotr8(b1)
    return out.astype(np.uint64)


def _reorder_table() -> np.ndarray:
    b = np.arange(256, dtype=np.int64)
    return ((((b << 6) & 0x40) | ((b << 1) & 0x20) | ((b << 2) & 0x08)
             | ((b >> 3) & 0x14) | ((b >> 2) & 0x01) | ((b >> 5) & 0x02)
             | ((b << 4) & 0x80)) & 0xFF).astype(np.uint64)


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = (_filter_table(LUT_A), _filter_table(LUT_B),
                   _reorder_table())
    return _TABLES


def _expand_iv(iv32: np.ndarray) -> np.ndarray:
    """64-bit IV registers from 29-bit IVs."""
    iv32 = np.asarray(iv32, np.uint64)
    x = (iv32 ^ np.uint64(IV_WHITEN)) & np.uint64(_M32)
    x = ((x << np.uint64(8)) | (x >> np.uint64(24))) & np.uint64(_M32)
    q = (iv32 << np.uint64(32)) | x
    return (q >> np.uint64(8)) | (q << np.uint64(56))


def tea1(iv32, key: bytes, n_bytes: int) -> np.ndarray:
    """TEA1 keystream of each IV under one 80-bit key: (len(iv32),
    n_bytes) uint8."""
    fa, fb, reorder = _tables()
    kreg = 0
    for i in range(10):
        kreg = ((kreg << 8) & _M32) | int(
            SBOX[((kreg >> 24) ^ key[i] ^ kreg) & 0xFF])
    iv = _expand_iv(np.atleast_1d(iv32))
    out = np.empty((len(iv), n_bytes), np.uint8)
    s8, s32, s40, s56 = (np.uint64(s) for s in (8, 32, 40, 56))
    w16, b8 = np.uint64(0xFFFF), np.uint64(0xFF)
    rounds = 54
    for j in range(n_bytes):
        for _ in range(rounds):
            sbox_out = SBOX[((kreg >> 24) ^ kreg) & 0xFF]
            kreg = ((kreg << 8) & _M32) | int(sbox_out)
            d12 = fa[(iv >> s8) & w16]
            d56 = fb[(iv >> s40) & w16]
            r4 = reorder[(iv >> s32) & b8]
            new = (d56 ^ (iv >> s56) ^ r4 ^ sbox_out) & b8
            iv = ((iv << s8) ^ (d12 << s32)) | new
        out[:, j] = (iv >> s56).astype(np.uint8)
        rounds = 19
    return out


def build_iv(mn, fn, tn, hn: int, direction: int = 0):
    """29-bit IV of TDMA time (tn, fn, mn) in hyperframe hn."""
    mn, fn, tn = (np.asarray(v, np.int64) for v in (mn, fn, tn))
    return ((tn - 1) | (fn << 2) | (mn << 7) | ((hn & 0x7FFF) << 13)
            | ((direction & 1) << 28))


def tb5(cn: int, la: int, cc: int, ck: bytes) -> bytes:
    """The encryption key of a cell: the 80-bit cipher key XOR the packed
    [la:14 cn:12 cc:6 cn:12 cc:6 cn:12 cc:6 cn:12] of its location area,
    main carrier and colour code."""
    cn, la, cc = cn & 0xFFF, la & 0x3FFF, cc & 0x3F
    mask = ((la << 66) | (cn << 54) | (cc << 48) | (cn << 36)
            | (cc << 30) | (cn << 18) | (cc << 12) | cn)
    return (int.from_bytes(ck, "big") ^ mask).to_bytes(10, "big")


def keystream_bits(iv32, eck: bytes, n_bits: int) -> np.ndarray:
    """(len(iv32), n_bits) keystream bits, MSB of each byte first."""
    ks = tea1(iv32, eck, (n_bits + 7) // 8)
    return np.unpackbits(ks, axis=1)[:, :n_bits]


def cipher_keys(seed: int, cells) -> dict:
    """An 80-bit common cipher key for each encrypted cell index, drawn
    from the seed."""
    rng = np.random.default_rng([seed, 5])
    return {i: bytes(rng.integers(0, 256, 10, dtype=np.uint8))
            for i in sorted(cells)}


def keystore_text(cells: list, keys: dict, cck_id: int) -> str:
    """The text keystore of the encrypted cells: each cell's network as
    TEA1 of security class 2 and its key as CCK number cck_id."""
    lines = ["# TEA1 common cipher keys of the benchmark's encrypted cells"]
    for i, key in sorted(keys.items()):
        c = cells[i]
        lines += [f"network mcc {c.mcc} mnc {c.mnc} ksg_type {KSG_TEA1} "
                  f"security_class {SECURITY_CLASS}",
                  f"key mcc {c.mcc} mnc {c.mnc} addr 0 key_type "
                  f"{KEYTYPE_CCK_SCK} key_num {cck_id} key "
                  f"{key.hex().upper()}"]
    return "\n".join(lines) + "\n"
