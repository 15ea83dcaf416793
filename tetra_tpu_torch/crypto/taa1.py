"""TAA1 authentication and key-management primitives (EN 300 392-7 annex).

Published algorithm set from the TETRA:BURST disclosure (reference at
crypto/taa1.c): challenge/response (TA11/12/21/22/41), CCK sealing
(TA31/32), SCK sealing (TA51/52), MGCK derivation (TA71), GCK sealing
(TA81/82), GSKO sealing (TA91/92) and the TB4..TB7 key combiners.  TB5 (the
ECK derivation used on the receive path) lives in crypto/state.py.

All inputs/outputs are `bytes`; 80-bit keys are 10 bytes, sealed blobs 15
bytes (ciphertext stealing over two HURDLE blocks).
"""

from __future__ import annotations

from . import hurdle

# ---------------------------------------------------------------------------
# Expansion / compression transforms (redundancy padding)
# ---------------------------------------------------------------------------


def _t80_to_120(b: bytes) -> bytes:
    out = bytearray(15)
    for i in range(5):
        out[3 * i] = (b[i] + b[9 - i]) & 0xFF
        out[3 * i + 1] = b[i]
        out[3 * i + 2] = b[9 - i]
    return bytes(out)


def _t80_to_128(b: bytes) -> bytes:
    body = _t80_to_120(b)
    head = body[0] ^ body[3] ^ body[6] ^ body[9] ^ body[12]
    return bytes([head]) + body


def _t80_to_120_alt(b: bytes) -> bytes:
    out = bytearray(16)
    for i in range(5):
        out[3 * i] = b[2 * i]
        out[3 * i + 1] = b[2 * i + 1]
        out[3 * i + 2] = b[2 * i] ^ b[2 * i + 1]
    return bytes(out[:15])


def _t80_to_128_alt(b: bytes) -> bytes:
    body = bytearray(16)
    body[:15] = _t80_to_120_alt(b)
    body[15] = (body[2] + body[5] + body[8] + body[11] + body[14]) & 0xFF
    return bytes(body)


def _t88_to_120(b: bytes) -> bytes:
    out = bytearray(15)
    out[0], out[1] = b[0], b[1]
    out[2] = b[0] ^ b[1]
    out[3], out[4], out[5] = b[2], b[3], b[4]
    out[6] = b[2] ^ b[3] ^ b[4]
    out[7], out[8], out[9] = b[5], b[6], b[7]
    out[10] = b[5] ^ b[6] ^ b[7]
    out[11], out[12], out[13] = b[8], b[9], b[10]
    out[14] = b[8] ^ b[9] ^ b[10]
    return bytes(out)


def _t120_to_88(b: bytes) -> bytes:
    idx = (0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13)
    return bytes(b[i] for i in idx)


def _t120_to_80_alt(b: bytes) -> bytes:
    idx = (0, 1, 3, 4, 6, 7, 9, 10, 12, 13)
    return bytes(b[i] for i in idx)


def _steal(sealed16: bytes) -> bytes:
    """CBC output (16) -> 15-byte sealed blob (drop byte 7)."""
    return sealed16[:7] + sealed16[8:16]


def _adjust16(key: bytes, vn: bytes) -> bytes:
    return bytes(key[i] ^ vn[i & 1] for i in range(16))


# ---------------------------------------------------------------------------
# Authentication
# ---------------------------------------------------------------------------


def ta11_ta41(key_k: bytes, challenge_rs: bytes) -> bytes:
    """K, RS -> KS (session authentication key); TA41 is the same map."""
    return hurdle.enc_cbc(_t80_to_128_alt(challenge_rs), key_k)


def ta12_ta22(key_ks: bytes, rand: bytes) -> tuple[bytes, bytes]:
    """KS, RAND1 -> (RES1 (4 bytes), DCK1 (10 bytes)); TA22 identical."""
    ct = hurdle.enc_cbc(_t80_to_128_alt(rand), key_ks)
    res = bytes([ct[0] ^ ct[3], ct[6], ct[9], ct[12] ^ ct[15]])
    dck = bytes(ct[i] for i in (1, 2, 4, 5, 7, 8, 10, 11, 13, 14))
    return res, dck


def ta21(key_k: bytes, challenge_rs: bytes) -> bytes:
    """K, RS -> KS' (reversed-challenge variant)."""
    return hurdle.enc_cbc(_t80_to_128_alt(challenge_rs[::-1]), key_k)


# ---------------------------------------------------------------------------
# CCK sealing
# ---------------------------------------------------------------------------


def _adjust_dck(dck: bytes, cck_id: bytes) -> bytes:
    return bytes(dck[i] ^ cck_id[i & 1] for i in range(10))


def ta31(unsealed_cck: bytes, cck_id: bytes, dck: bytes) -> bytes:
    plain = _t80_to_120_alt(unsealed_cck) + b"\x00"
    hk = _t80_to_128(_adjust_dck(dck, cck_id))
    return _steal(hurdle.enc_cbc(plain, hk))


def ta32(sealed_cck: bytes, cck_id: bytes, dck: bytes
         ) -> tuple[bytes, bool]:
    hk = _t80_to_128(_adjust_dck(dck, cck_id))
    p = hurdle.dec_cts(sealed_cck, hk)
    mf = any((p[3 * i] ^ p[3 * i + 1]) != p[3 * i + 2] for i in range(5))
    return _t120_to_80_alt(p), mf


# ---------------------------------------------------------------------------
# SCK sealing
# ---------------------------------------------------------------------------


def ta51(unsealed: bytes, vn: bytes, key: bytes, key_n: int) -> bytes:
    assert (key_n & 0xE0) == 0
    plain = _t88_to_120(unsealed + bytes([key_n])) + b"\x00"
    return _steal(hurdle.enc_cbc(plain, _adjust16(key, vn)))


def ta52(sealed: bytes, key: bytes, vn: bytes) -> tuple[bytes, bool, int]:
    p = hurdle.dec_cts(sealed, _adjust16(key, vn))
    u = _t120_to_88(p)
    mf = ((p[0] ^ p[1]) != p[2]
          or (p[3] ^ p[4] ^ p[5]) != p[6]
          or (p[7] ^ p[8] ^ p[9]) != p[10]
          or (p[11] ^ p[12] ^ p[13]) != p[14]
          or bool(u[10] & 0xE0))
    return u[:10], mf, u[10]


# ---------------------------------------------------------------------------
# Group keys
# ---------------------------------------------------------------------------


def ta71(gck: bytes, cck: bytes) -> bytes:
    """GCK, CCK -> MGCK."""
    plain = _t80_to_128_alt(bytes(gck[i] ^ cck[i] for i in range(10)))
    hk = bytes(list(gck[0:6])
               + [gck[6 + i] ^ cck[i] for i in range(4)]
               + list(cck[4:10]))
    return hurdle.enc_cbc(plain, hk)[3:13]


def ta81(unsealed_gck: bytes, gck_vn: bytes, gck_n: bytes,
         key: bytes) -> bytes:
    p = bytearray(16)
    p[0:4] = unsealed_gck[0:4]
    p[4] = p[0] ^ p[1] ^ p[2] ^ p[3]
    p[5:9] = unsealed_gck[4:8]
    p[9] = p[5] ^ p[6] ^ p[7] ^ p[8]
    p[10:12] = unsealed_gck[8:10]
    p[12:14] = gck_n[0:2]
    p[14] = p[10] ^ p[11] ^ p[12] ^ p[13]
    p[15] = 0
    return _steal(hurdle.enc_cbc(bytes(p), _adjust16(key, gck_vn)))


def ta82(sealed_gck: bytes, gck_vn: bytes, key: bytes
         ) -> tuple[bytes, bytes, bool]:
    p = hurdle.dec_cts(sealed_gck, _adjust16(key, gck_vn))
    gck = bytes(p[i] for i in (0, 1, 2, 3, 5, 6, 7, 8, 10, 11))
    gck_n = bytes(p[12:14])
    mf = ((p[14] != p[10] ^ p[11] ^ p[12] ^ p[13])
          or (p[9] != p[5] ^ p[6] ^ p[7] ^ p[8])
          or (p[4] != p[0] ^ p[1] ^ p[2] ^ p[3]))
    return gck, gck_n, mf


def ta91(unsealed_gsko: bytes, gsko_vn: bytes, key: bytes) -> bytes:
    """12-byte GSKO sealed with TA81 using its last 2 bytes as 'N'."""
    return ta81(unsealed_gsko[:10], gsko_vn, unsealed_gsko[10:12], key)


def ta92(sealed_gsko: bytes, gsko_vn: bytes, key: bytes
         ) -> tuple[bytes, bool]:
    gck, n, mf = ta82(sealed_gsko, gsko_vn, key)
    return gck + n, mf


# ---------------------------------------------------------------------------
# Key combiners (TB5 lives in state.py with the RX path)
# ---------------------------------------------------------------------------


def tb4(dck1: bytes, dck2: bytes) -> bytes:
    return bytes(a ^ b for a, b in zip(dck1, dck2))


def tb6(sck: bytes, cn: int, ssi: int) -> bytes:
    """ECK for class-2 (SCK) networks: XOR mask [cn:12 ssi:24 cn:12 ssi:24
    lsb(ssi):8] onto the 80-bit SCK (taa1.c:423-455)."""
    cn &= 0xFFF
    ssi &= 0xFFFFFF
    mask = (cn << 68) | (ssi << 44) | (cn << 32) | (ssi << 8) | (ssi & 0xFF)
    v = int.from_bytes(sck, "big") ^ mask
    return v.to_bytes(10, "big")


def tb7(gsko: bytes) -> bytes:
    """12-byte GSKO -> 16-byte EGSKO with parity bytes."""
    out = bytearray(16)
    for i in range(4):
        out[4 * i] = gsko[3 * i]
        out[4 * i + 1] = gsko[3 * i + 1]
        out[4 * i + 2] = gsko[3 * i + 2]
        out[4 * i + 3] = gsko[3 * i] ^ gsko[3 * i + 1] ^ gsko[3 * i + 2]
    return bytes(out)
