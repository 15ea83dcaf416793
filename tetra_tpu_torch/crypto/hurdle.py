"""HURDLE 64-bit Feistel block cipher (TAA1 key-management primitive).

Published structure from the Midnight Blue TETRA:BURST disclosure (reference
carries it at crypto/hurdle.c): 16 rounds, 128-bit key expanded to 16 round
keys by byte rotation + per-round XOR constants; the round function chains
the S-box over key-added half-block bytes and spreads 8 nibbles into the
32-bit output.  Includes the CBC-encrypt (2 blocks) and ciphertext-stealing
decrypt modes used by the TA31/32/51/52/81/82 seal operations.

Word semantics follow the little-endian layout of the reference
(32-bit halves handled as integers; serialization is explicit LE).
"""

from __future__ import annotations

from .hurdle_tables import HURDLE_KEY_XOR, HURDLE_SBOX

# key byte rotation offsets per round (hurdle_set_key's unrolled schedule)
_ROT = (0, 5, 10, 15, 4, 7, 14, 3, 8, 13, 2, 9, 12, 1, 6, 11)

# nibble -> 32-bit spread (little-endian build of g_adwReorder)
_REORDER = tuple(
    ((x & 1) << 31) | (((x >> 1) & 1) << 23) | (((x >> 2) & 1) << 15)
    | (((x >> 3) & 1) << 7) for x in range(16))


def expand_key(key: bytes) -> list[bytes]:
    """128-bit key -> 16 x 16-byte round keys."""
    assert len(key) == 16
    rks = []
    for r in range(16):
        rot = _ROT[r]
        rk = bytes((key[(rot + i) % 16] ^ HURDLE_KEY_XOR[16 * r + i]) & 0xFF
                   for i in range(16))
        rks.append(rk)
    return rks


def _f(rhs: int, rk: bytes) -> int:
    """Round function: S-box chain over key-added RHS bytes, 8 nibble pushes."""
    b = [(rhs >> (8 * i)) & 0xFF for i in range(4)]  # LE bytes
    out = 0
    st = HURDLE_SBOX[(b[3] + rk[15]) & 0xFF]
    st = HURDLE_SBOX[((b[2] + rk[14]) ^ st) & 0xFF]
    st = HURDLE_SBOX[((b[1] + rk[13]) ^ st) & 0xFF]
    st = HURDLE_SBOX[((b[0] + rk[12]) ^ st) & 0xFF]
    seq = ((3, 11), (1, 10), (2, 9), (0, 8), (1, 7), (3, 6), (0, 5), (2, 4))
    for byte_i, key_i in seq:
        st = HURDLE_SBOX[((b[byte_i] + rk[key_i]) ^ st) & 0xFF]
        out = (out >> 1) | _REORDER[st & 0xF]
    return out & 0xFFFFFFFF


def encrypt_block(block: bytes, round_keys: list[bytes],
                  decrypt: bool = False) -> bytes:
    lhs = int.from_bytes(block[0:4], "little")
    rhs = int.from_bytes(block[4:8], "little")
    order = reversed(round_keys) if decrypt else round_keys
    for rk in order:
        tmp = _f(rhs, rk) ^ lhs
        lhs, rhs = rhs, tmp
    return rhs.to_bytes(4, "little") + lhs.to_bytes(4, "little")


def enc_cbc(plain16: bytes, key: bytes) -> bytes:
    """Two-block CBC encryption (HURDLE_enc_cbc)."""
    rks = expand_key(key)
    c0 = encrypt_block(plain16[0:8], rks)
    inter = bytes(c0[i] ^ plain16[8 + i] for i in range(8))
    c1 = encrypt_block(inter, rks)
    return c0 + c1


def dec_cts(cipher15: bytes, key: bytes) -> bytes:
    """15-byte ciphertext-stealing decryption (HURDLE_dec_cts)."""
    rks = expand_key(key)
    inter = bytearray(16)
    inter[8:16] = encrypt_block(cipher15[7:15], rks, decrypt=True)
    inter[0:7] = cipher15[0:7]
    inter[7] = inter[15]
    inter[0:8] = encrypt_block(bytes(inter[0:8]), rks, decrypt=True)
    for i in range(7):
        inter[8 + i] ^= cipher15[i]
    # inter[15] is scratch; plaintext is 15 bytes
    return bytes(inter[0:15])
