"""TX-side TETRA FEC chain (type-1 -> type-5 bits), host NumPy.

This is the golden fixture generator the reference lacks (SURVEY.md section 4):
it re-creates the standard's encode path so every RX stage can be tested
against exact vectors, and doubles as a TX capability (the reference keeps
latent TX builders at phy/tetra_burst.c:171-269 and
lower_mac/tetra_conv_enc.c:46-95).

Encode pipeline per clause 8.2 of EN 300 392-2:
  type-1 (MAC bits) -> +CRC16 -> +4 tail bits = type-2
  type-2 -> rate-1/4 K=5 mother code -> puncture = type-3
  type-3 -> block interleave = type-4
  type-4 -> scramble = type-5
All functions are bit-per-byte uint8 arrays, vectorized over a leading batch
axis where noted.
"""

from __future__ import annotations

import numpy as np

from .. import params as P


# ---------------------------------------------------------------------------
# CRC-16
# ---------------------------------------------------------------------------

def crc16_bits(bits: np.ndarray, init: int = P.CRC16_INIT) -> int:
    """Bitwise CRC-16 (poly 0x1021) over a 1-D bit array, MSB-first.

    Matches lower_mac/crc_simple.c:69-86 semantics: crc ^= bit<<15 then
    shift/xor with the polynomial.
    """
    crc = init
    for b in np.asarray(bits, np.uint8):
        crc ^= int(b) << 15
        if crc & 0x8000:
            crc = ((crc << 1) ^ P.CRC16_POLY) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def append_crc16(bits: np.ndarray) -> np.ndarray:
    """type-1 -> type-1+CRC. The transmitted CRC is the bitwise complement of
    the register (X.25 FCS), sent MSB-first, so that running the checker over
    data+fcs yields the good residue 0x1d0f."""
    crc = crc16_bits(bits) ^ 0xFFFF
    crc_bits = np.array([(crc >> (15 - i)) & 1 for i in range(16)], np.uint8)
    return np.concatenate([np.asarray(bits, np.uint8), crc_bits])


# ---------------------------------------------------------------------------
# Mother code (rate 1/4 K=5 data; rate 1/3 K=5 speech)
# ---------------------------------------------------------------------------

def conv_encode(bits: np.ndarray, polys: np.ndarray = P.CONV_CCH_POLYS) -> np.ndarray:
    """Convolutional mother-code encoder, zero initial state.

    polys has shape (N, K) with taps over [x_n, x_{n-1}, .., x_{n-K+1}]
    (K = 5 for both TETRA mother codes; arbitrary K supported for the
    generic decoder, rx/viterbi.viterbi_decode_generic).
    Output shape (len(bits)*N,), interleaved g1..gN per input bit
    (semantics of lower_mac/tetra_conv_enc.c:46-95).
    """
    bits = np.asarray(bits, np.uint8)
    n_out, K = polys.shape
    # Build the delayed-bit matrix: row d = bits delayed by d (zero padded)
    hist = np.zeros((K, len(bits)), np.uint8)
    for d in range(K):
        if d == 0:
            hist[0] = bits
        else:
            hist[d, d:] = bits[:-d]
    out = (polys.astype(np.int32) @ hist.astype(np.int32)) % 2  # (N, len)
    return out.T.reshape(-1).astype(np.uint8)


def puncture(mother: np.ndarray, punct_id: int, out_len: int) -> np.ndarray:
    """Mother stream -> type-3 bits by puncture-table selection."""
    idx = P.puncture_indices(punct_id, out_len)
    return np.asarray(mother, np.uint8)[idx]


# ---------------------------------------------------------------------------
# Interleaver / scrambler
# ---------------------------------------------------------------------------

def block_interleave(bits: np.ndarray, a: int) -> np.ndarray:
    """type-3 -> type-4: out[k(i)] = in[i] (8.2.4.1)."""
    bits = np.asarray(bits, np.uint8)
    out = np.empty_like(bits)
    out[P.interleave_indices(len(bits), a)] = bits
    return out


def scramb_keystream(lfsr_init: int, length: int) -> np.ndarray:
    """TETRA scrambling sequence p(k) (8.2.5).

    32-bit Fibonacci LFSR with taps SCRAMB_TAPS; the output bit is the XOR of
    the taps and is shifted back in at the top (tetra_scramb.c:34-50).
    """
    out = np.empty(length, np.uint8)
    lfsr = lfsr_init & 0xFFFFFFFF
    for i in range(length):
        bit = 0
        for t in P.SCRAMB_TAPS:
            bit ^= lfsr >> (32 - t)
        bit &= 1
        lfsr = (lfsr >> 1) | (bit << 31)
        out[i] = bit
    return out


_KEYSTREAM_CACHE: dict[tuple[int, int], np.ndarray] = {}


def scramble(bits: np.ndarray, lfsr_init: int) -> np.ndarray:
    """type-4 <-> type-5 (self-inverse XOR with the scrambling sequence)."""
    bits = np.asarray(bits, np.uint8)
    key = (lfsr_init, len(bits))
    ks = _KEYSTREAM_CACHE.get(key)
    if ks is None:
        ks = scramb_keystream(lfsr_init, len(bits))
        _KEYSTREAM_CACHE[key] = ks
    return bits ^ ks


# ---------------------------------------------------------------------------
# RM(30,14) broadcast-block code
# ---------------------------------------------------------------------------

def rm3014_encode(bits14: np.ndarray) -> np.ndarray:
    """14 info bits -> 30 coded bits, systematic [info | parity]."""
    bits14 = np.asarray(bits14, np.uint8)
    assert bits14.shape == (14,)
    parity = (bits14.astype(np.int32) @ P.RM3014_PARITY.astype(np.int32)) % 2
    return np.concatenate([bits14, parity.astype(np.uint8)])


# ---------------------------------------------------------------------------
# Full per-block encode (type-1 -> type-5)
# ---------------------------------------------------------------------------

def encode_block(type1: np.ndarray, blk_type: int, scramb_init: int) -> np.ndarray:
    """Encode type-1 MAC bits of a control block into type-5 burst bits.

    Inverse of the RX pipeline at lower_mac/tetra_lower_mac.c:184-215.
    """
    name, t345, t2, t1, ia, has_crc = P.BLK_PARAMS[blk_type]
    type1 = np.asarray(type1, np.uint8)
    assert len(type1) == t1, f"{name}: want {t1} type-1 bits, got {len(type1)}"

    if blk_type == P.TPSAP_T_BBK:
        type2 = type1  # RM3014 handles the redundancy
        type3 = rm3014_encode(type2[:14])
        type4 = type3  # no interleaving for the 30-bit broadcast block
    else:
        # type-2 = type-1 + 16 CRC bits + 4 zero tail bits (8.2.3)
        type2 = np.concatenate([append_crc16(type1), np.zeros(4, np.uint8)])
        assert len(type2) == t2
        mother = conv_encode(type2, P.CONV_CCH_POLYS)
        type3 = puncture(mother, P.PUNCT_2_3, t345)
        type4 = block_interleave(type3, ia)

    if blk_type == P.TPSAP_T_SB1:
        scramb_init = P.SCRAMB_INIT
    return scramble(type4, scramb_init)
