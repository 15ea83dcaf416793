"""Batched RX FEC (port of tetra_tpu/rx/fec.py): descramble, deinterleave,
depuncture, Viterbi, CRC-16 and RM(30,14), for whole batches of rows in
one pass on the device of the rows (or of the keystream table).

Ported: the per-type block decode (decode_block); the fused mixed-type
decode the per-channel receiver runs once per cycle (decode_blocks_mixed),
whose packed program _decode_mixed_packed the row-sharded FEC runs
(parallel/mesh.sharded_fec_decode); and the fleet engine's packed decode
by row type (decode_rows_typed_packed): SB1/SB2/NDB rows on a 144-step
trellis, SCH-F rows on 288 steps, BBK rows by RM(30,14).

The fleet decode takes each row kind in one pass.  Nothing is padded (the
reference pads batches to bucket sizes to keep compiled XLA shapes, which
eager PyTorch does not have): every call decodes exactly its rows.  Only
a kind of more than _MAX_CHUNK_ROWS rows runs as several passes, every
chunk uploaded and enqueued before any result is fetched (on CUDA the
fetches run on a second stream, so chunk j's copy overlaps chunk j+1's
trellis).  Results, in input row order, are bit-exact vs the reference's
fleet programs on every row's type-1 bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from .. import spans as S
from ..tx import fec_enc
from .viterbi import viterbi_decode


@lru_cache(maxsize=4096)
def keystream(lfsr_init: int, length: int) -> np.ndarray:
    return fec_enc.scramb_keystream(lfsr_init, length)


@lru_cache(maxsize=16)
def _deinterleave_idx(K: int, a: int) -> np.ndarray:
    return P.interleave_indices(K, a)


_DEV: dict = {}


def _on(device, key, make) -> torch.Tensor:
    """Device-resident copy of a host constant table, made once."""
    k = (key, str(device))
    if k not in _DEV:
        _DEV[k] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return _DEV[k]


def descramble(bits: torch.Tensor, lfsr_init: int) -> torch.Tensor:
    """bits: (..., L) uint8; scrambling is a self-inverse XOR."""
    ks = keystream(int(lfsr_init), bits.shape[-1])
    return bits ^ torch.from_numpy(ks).to(bits.device)


def deinterleave(bits: torch.Tensor, a: int) -> torch.Tensor:
    """Type-4 -> type-3 bits: out[..., i] = bits[..., k(i)]."""
    K = bits.shape[-1]
    idx = _on(bits.device, ("deint", K, a),
              lambda: _deinterleave_idx(K, a).astype(np.int64))
    return bits[..., idx]


def depuncture_soft(bits: torch.Tensor, punct_id: int, mother_len: int,
                    n_out: int) -> torch.Tensor:
    """Hard type-3 bits (B, L) -> soft mother (B, mother_len//n_out, n_out):
    0 at punctured positions, +1 for bit 0 and -1 for bit 1 elsewhere."""
    L = bits.shape[-1]
    idx = _on(bits.device, ("punct", punct_id, L),
              lambda: P.puncture_indices(punct_id, L).astype(np.int64))
    mother = torch.zeros(bits.shape[:-1] + (mother_len,), dtype=torch.float32,
                         device=bits.device)
    mother[..., idx] = 1.0 - 2.0 * bits.to(torch.float32)
    return mother.reshape(bits.shape[:-1] + (mother_len // n_out, n_out))


@lru_cache(maxsize=16)
def _crc_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M, r0): crc(bits) = (bits @ M) xor r0 over GF(2), CRC MSB-first."""
    def crc_to_bits(c):
        return np.array([(c >> (15 - i)) & 1 for i in range(16)], np.uint8)

    zero = np.zeros(length, np.uint8)
    r0 = fec_enc.crc16_bits(zero)
    M = np.empty((length, 16), np.uint8)
    for i in range(length):
        e = zero.copy()
        e[i] = 1
        M[i] = crc_to_bits(fec_enc.crc16_bits(e) ^ r0)
    return M, crc_to_bits(r0)


def crc16_check(bits: torch.Tensor) -> torch.Tensor:
    """(B, L) bits -> (B,) bool: the CRC residue equals CRC16_GOOD."""
    L = bits.shape[-1]
    dev = bits.device
    # float32 matmul of 0/1 operands: integer sums <= L, exact
    M = _on(dev, ("crcM", L), lambda: _crc_matrix(L)[0].astype(np.float32))
    r0 = _on(dev, ("crc0", L), lambda: _crc_matrix(L)[1].astype(np.int32))
    good = _on(dev, "crc_good", lambda: np.array(
        [(P.CRC16_GOOD >> (15 - i)) & 1 for i in range(16)], np.int32))
    residue = (bits.to(torch.float32) @ M).to(torch.int32) % 2
    return ((residue ^ r0) == good).all(dim=-1)


@lru_cache(maxsize=1)
def _rm_codebook_pm1() -> np.ndarray:
    """(30, 16384) +-1 image of every RM(30,14) codeword (column i encodes
    info word i, MSB-first)."""
    info = ((np.arange(1 << 14)[:, None] >> np.arange(13, -1, -1)) & 1)
    cw = np.concatenate([info, (info @ P.RM3014_PARITY) % 2], axis=1)
    return np.ascontiguousarray((1.0 - 2.0 * cw).T.astype(np.float32))


def rm3014_decode(bits30: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 30) coded bits -> ((B, 14) info bits, (B,) ok): nearest-codeword
    decode by one +-1 correlation against the whole codebook; ok when the
    distance is <= 3 (d_min = 8).  Scores are exact small integers."""
    dev = bits30.device
    x = 1.0 - 2.0 * bits30.to(torch.float32)
    scores = x @ _on(dev, "rm_codebook", _rm_codebook_pm1)
    best = scores.argmax(dim=-1).to(torch.int32)      # first maximum
    dist = (30.0 - scores.max(dim=-1).values) * 0.5
    sh = torch.arange(13, -1, -1, dtype=torch.int32, device=dev)
    info = ((best[..., None] >> sh) & 1).to(torch.uint8)
    return info, dist <= 3.0


# ---------------------------------------------------------------------------
# Per-type block decode (type-5 -> type-1 + CRC flag)
# ---------------------------------------------------------------------------


def _decode_bbk_block(type5: torch.Tensor, ks: torch.Tensor):
    return rm3014_decode(type5 ^ ks)


def _decode_cch_block(type5: torch.Tensor, ks: torch.Tensor, blk_type: int):
    _, _, t2, t1, ia, _ = P.BLK_PARAMS[blk_type]
    soft = depuncture_soft(deinterleave(type5 ^ ks, ia), P.PUNCT_2_3, t2 * 4,
                           4)
    type2 = viterbi_decode(soft, "cch")
    return type2[..., :t1], crc16_check(type2[..., :t1 + 16])


def decode_block(type5: torch.Tensor, blk_type: int, scramb_init
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of type-5 blocks of one type on type5's device.

    type5: (B, type345_bits) uint8.  Returns (type1 bits (B, t1), ok (B,)).
    SB1 blocks always use the predefined scrambling code (tetra_lower_mac.c:
    186-190); BBK blocks use the RM(30,14) path.  scramb_init: one LFSR init
    for the whole batch, or a length-B sequence of per-row inits."""
    if blk_type == P.TPSAP_T_SB1:
        scramb_init = P.SCRAMB_INIT
    t345 = P.BLK_PARAMS[blk_type][1]
    B = type5.shape[0]
    if np.ndim(scramb_init) == 0:
        ks = keystream(int(scramb_init), t345)
    else:
        if len(scramb_init) != B:
            raise ValueError(f"{len(scramb_init)} scrambling codes for {B} "
                             f"rows")
        ks = np.stack([keystream(int(s), t345) for s in scramb_init])
    ks = torch.from_numpy(np.ascontiguousarray(ks)).to(type5.device)
    if blk_type == P.TPSAP_T_BBK:
        return _decode_bbk_block(type5, ks)
    return _decode_cch_block(type5, ks, blk_type)


# ---------------------------------------------------------------------------
# Mixed-type decode: every downlink block type in one pass
# ---------------------------------------------------------------------------

_MIX_SB1, _MIX_NDB, _MIX_SCHF, _MIX_BBK = 0, 1, 2, 3
_MIX_VARIANTS = ((120, 80, 60, 11), (216, 144, 124, 101),
                 (432, 288, 268, 103))
_MIX_T345 = 432
_MIX_T2 = 288
_MIX_T1 = 268
# Soft pad after a shorter block's zero-terminated tail: the all-zero
# codeword at an amplitude no path-metric spread can overcome, so the
# traceback from state 0 at the padded end passes through state 0 at the
# true end and the decoded prefix is exactly the per-type decode.
_MIX_PAD_AMP = 1000.0

_MIX_TSEL_OF = np.full(8, -1, np.int32)
_MIX_TSEL_OF[P.TPSAP_T_SB1] = _MIX_SB1
_MIX_TSEL_OF[P.TPSAP_T_SB2] = _MIX_NDB
_MIX_TSEL_OF[P.TPSAP_T_NDB] = _MIX_NDB
_MIX_TSEL_OF[P.TPSAP_T_SCH_F] = _MIX_SCHF
_MIX_TSEL_OF[P.TPSAP_T_BBK] = _MIX_BBK

_T5_BYTES = _MIX_T345 // 8     # 54
_T1_BYTES = 34                 # ceil(268 / 8)


def _soft_padded(type4, t345, t2, ia, t2_pad):
    """Deinterleave + depuncture one variant, zero-codeword padded to
    t2_pad trellis steps."""
    soft = depuncture_soft(deinterleave(type4[:, :t345], ia), P.PUNCT_2_3,
                           t2 * 4, 4)
    if t2 < t2_pad:
        pad = torch.full((soft.shape[0], t2_pad - t2, 4), _MIX_PAD_AMP,
                         dtype=torch.float32, device=soft.device)
        soft = torch.cat([soft, pad], dim=1)
    return soft


def _decode_cch_core(type4, tsel):
    """Convolutional-coded (SB1/NDB/SCH-F) half of the mixed decode: every
    variant depunctured, selected by tsel, one batched Viterbi + CRC.
    Returns ((B, 268) uint8 type-1 rows, (B,) ok)."""
    softs = [_soft_padded(type4, t345, t2, ia, _MIX_T2)
             for t345, t2, _, ia in _MIX_VARIANTS]
    t3d = tsel[:, None, None]
    soft = torch.where(t3d == _MIX_SB1, softs[0],
                       torch.where(t3d == _MIX_NDB, softs[1], softs[2]))
    type2 = viterbi_decode(soft, "cch")
    oks = [crc16_check(type2[..., :t1 + 16]) for _, _, t1, _ in _MIX_VARIANTS]
    ok = torch.where(tsel == _MIX_SB1, oks[0],
                     torch.where(tsel == _MIX_NDB, oks[1], oks[2]))
    return type2[:, :_MIX_T1], ok


def _decode_mixed_core(type4_in, ks, tsel):
    """Shared body of the mixed decode: (B, 432) type-5 bits and keystream
    rows, (B,) variant ids -> ((B, 272) type-1 bits padded to whole bytes,
    (B,) ok)."""
    B = type4_in.shape[0]
    type4 = type4_in ^ ks
    type1, ok = _decode_cch_core(type4, tsel)
    info14, ok_bbk = rm3014_decode(type4[:, :30])
    bbk_row = torch.cat([info14, info14.new_zeros((B, _MIX_T1 - 14))], dim=1)
    is_bbk = tsel == _MIX_BBK
    type1 = torch.where(is_bbk[:, None], bbk_row, type1)
    ok = torch.where(is_bbk, ok_bbk, ok)
    return torch.cat([type1, type1.new_zeros((B, _T1_BYTES * 8 - _MIX_T1))],
                     dim=1), ok


def decode_blocks_mixed(blocks: list[tuple[int, np.ndarray, int]], device
                        ) -> list[tuple[np.ndarray, bool]]:
    """Decode a heterogeneous batch of type-5 blocks in one pass on
    `device`.

    blocks: [(blk_type, type5_bits, scramb_init)] -- every downlink block
    type (SB1/SB2/NDB/SCH-F/BBK; SB1 rows use the fixed SCRAMB_INIT per
    tetra_lower_mac.c:186-190 whatever init is passed).  Returns
    [(type1_bits, crc_ok)] in order, each sliced to its type's length,
    bit-exact vs decode_block (the _MIX_PAD_AMP note).  A batch holding a
    type outside the variant table (SCH/HU: uplink only, never emitted by
    the downlink burst splitter) decodes row by row through decode_block
    instead."""
    tsel = _MIX_TSEL_OF[np.fromiter((b[0] for b in blocks), np.int64,
                                    len(blocks))]
    if (tsel < 0).any():
        out = []
        for bt, bb, sc in blocks:
            t1b, okb = decode_block(torch.from_numpy(np.ascontiguousarray(
                bb, np.uint8)[None]).to(device), bt, sc)
            out.append((t1b[0].cpu().numpy(), bool(okb[0])))
        return out
    B = len(blocks)
    t5 = np.zeros((B, _MIX_T345), np.uint8)
    ksm = np.zeros((B, _MIX_T345), np.uint8)
    t1s = []
    for j, (blk_type, bits, scramb) in enumerate(blocks):
        _, t345, _, t1, _, _ = P.BLK_PARAMS[blk_type]
        if blk_type == P.TPSAP_T_SB1:
            scramb = P.SCRAMB_INIT
        t5[j, :t345] = bits
        ksm[j, :t345] = keystream(int(scramb), t345)
        t1s.append(t1)
    to = lambda a: torch.from_numpy(a).to(device)
    type1, ok = _decode_mixed_core(to(t5), to(ksm), to(tsel))
    type1 = type1.cpu().numpy()
    ok = ok.cpu().numpy()
    return [(type1[j, :t1s[j]], bool(ok[j])) for j in range(B)]


# ---------------------------------------------------------------------------
# Packed decode by row type (the fleet's per-superblock FEC)
# ---------------------------------------------------------------------------

_SHORT_T345 = 216              # max type-5 bits over SB1/SB2/NDB
_SHORT_T5_BYTES = 27
_SHORT_T2 = 144                # NDB trellis length (SB1 pads 80 -> 144)
_SHORT_T1_BYTES = 16           # 124 type-1 bits + 4 CRC bits
_SHORT_VARIANTS = _MIX_VARIANTS[:2]


def _unpack_rows(t5p: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, nbits//8) uint8 MSB-first packed rows -> (B, nbits) uint8 bits."""
    sh = torch.arange(7, -1, -1, dtype=torch.uint8, device=t5p.device)
    return ((t5p[:, :, None] >> sh) & 1).reshape(t5p.shape[0], nbits)


def _ks_from_table(ks_table: torch.Tensor, scramb_idx: torch.Tensor
                   ) -> torch.Tensor:
    """Keystream rows by table-slot index."""
    return ks_table[scramb_idx.long()]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8n) bits -> (B, n) uint8, MSB-first."""
    B = bits.shape[0]
    w = (1 << torch.arange(7, -1, -1, device=bits.device)).to(torch.int32)
    return (bits.reshape(B, -1, 8).to(torch.int32) * w).sum(-1).to(
        torch.uint8)


def _pack_t1(type1pad: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(B, 272) bits + (B,) ok -> (B, 35) uint8 [packed type1 | ok]."""
    return torch.cat([_pack_bits(type1pad), ok[:, None].to(torch.uint8)],
                     dim=1)


def _decode_mixed_packed(t5p, ks_table, scramb_idx, tsel):
    """The mixed decode on packed rows, on the rows' device: t5p (B, 54)
    uint8 MSB-first type-5 rows, scramb_idx (B,) rows of the (S, 432)
    keystream table, tsel (B,) variant ids -> (B, 35) uint8 [packed type1
    | ok].  The program of the reference's row-sharded FEC
    (parallel/mesh.sharded_fec_decode)."""
    type5 = _unpack_rows(t5p, _MIX_T345)
    type1, ok = _decode_mixed_core(type5, _ks_from_table(ks_table,
                                                         scramb_idx), tsel)
    return _pack_t1(type1, ok)


def _decode_short_packed(t5p, ks_table, scramb_idx, tsel):
    """SB1/SB2/NDB rows: t5p (B, 27) packed, tsel in {SB1, NDB}.  Returns
    (B, 17) uint8 [first 128 decoded bits packed | ok] (bits 124..127 are
    an NDB row's leading CRC bits, as in the reference)."""
    type4 = _unpack_rows(t5p, _SHORT_T345) \
        ^ _ks_from_table(ks_table, scramb_idx)[:, :_SHORT_T345]
    softs = [_soft_padded(type4, t345, t2, ia, _SHORT_T2)
             for t345, t2, _, ia in _SHORT_VARIANTS]
    soft = torch.where(tsel[:, None, None] == _MIX_SB1, softs[0], softs[1])
    type2 = viterbi_decode(soft, "cch")
    ok = torch.where(tsel == _MIX_SB1, crc16_check(type2[..., :60 + 16]),
                     crc16_check(type2[..., :124 + 16]))
    return torch.cat([_pack_bits(type2[:, :_SHORT_T1_BYTES * 8]),
                      ok[:, None].to(torch.uint8)], dim=1)


def _decode_schf_packed(t5p, ks_table, scramb_idx):
    """SCH-F rows: full 432-bit rows, 288-step trellis; (B, 35) output."""
    B = t5p.shape[0]
    type4 = _unpack_rows(t5p, _MIX_T345) ^ _ks_from_table(ks_table,
                                                          scramb_idx)
    t345, t2, t1, ia = _MIX_VARIANTS[2]
    soft = _soft_padded(type4, t345, t2, ia, t2)
    type2 = viterbi_decode(soft, "cch")
    ok = crc16_check(type2[..., :t1 + 16])
    pad = type2.new_zeros((B, _T1_BYTES * 8 - _MIX_T1))
    return _pack_t1(torch.cat([type2[:, :_MIX_T1], pad], dim=1), ok)


def _decode_bbk_packed(t5p4, ks_table, scramb_idx):
    """BBK rows: RM(30,14) on the first 30 bits; (B, 35) output."""
    bits32 = _unpack_rows(t5p4, 32)
    ks = _ks_from_table(ks_table, scramb_idx)[:, :30]
    info14, ok = rm3014_decode(bits32[:, :30] ^ ks)
    pad = info14.new_zeros((info14.shape[0], _T1_BYTES * 8 - 14))
    return _pack_t1(torch.cat([info14, pad], dim=1), ok)


# ---------------------------------------------------------------------------
# Dispatch of the packed programs
# ---------------------------------------------------------------------------

# The most rows of one kind decoded in one pass: a bound on one pass's
# device memory, not a tuning.  A steady superblock stays below it (148,030
# rows at 1024 carriers); the warm-up may pass it, when carriers lock with
# their whole bit backlog (the engine's row buffer holds three rows a slot
# of a channel's 1<<16-bit ring).
_MAX_CHUNK_ROWS = 1 << 18

_COPY_STREAMS: dict = {}


def _chunks(rows: np.ndarray) -> list:
    """rows in chunks of at most _MAX_CHUNK_ROWS."""
    return [rows[s:s + _MAX_CHUNK_ROWS]
            for s in range(0, len(rows), _MAX_CHUNK_ROWS)]


class _Dispatch:
    """One batch's programs on `dev`: up() uploads a chunk's rows,
    fetch() queues a chunk's result for the host, wait() returns after
    every queued fetch has landed.  On CUDA an upload is a non-blocking
    copy from pinned memory on the current stream, and each fetch a
    non-blocking copy into pinned memory on this device's copy stream,
    ordered after the work enqueued so far (its own chunk's program, not
    the next one's), so chunk j's fetch overlaps chunk j+1's trellis; wait()
    is the batch's one synchronize.  On the CPU both are the tensors
    themselves."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.copy = None
        if dev.type == "cuda":
            if dev not in _COPY_STREAMS:
                _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
            self.copy = _COPY_STREAMS[dev]

    def up(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.copy is None:
            return t
        return t.pin_memory().to(self.dev, non_blocking=True)

    def fetch(self, res: torch.Tensor) -> torch.Tensor:
        if self.copy is None:
            return res
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        self.copy.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.copy):
            host.copy_(res, non_blocking=True)
        # the copy stream still reads res after the caller drops it
        res.record_stream(self.copy)
        return host

    def wait(self) -> None:
        with S.span("fec.wait"):
            if self.copy is not None:
                self.copy.synchronize()


def decode_rows_typed_packed(t5p: np.ndarray, blk_types: np.ndarray,
                             scramb_idx: np.ndarray, ks_table: torch.Tensor
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Packed decode by row type on ks_table's device: t5p (N, 54) packed
    type-5 rows, scramb_idx (N,) rows of the (S, 432) keystream table
    (row 0 = SCRAMB_INIT; SB1 rows are forced to it).  SB1/SB2/NDB rows
    upload 27 bytes and fetch 17, SCH-F rows 54 and 35, BBK rows 4 and 35,
    each kind in one pass (_chunks), every pass enqueued before any is
    fetched.  Returns (packed type1 (N, 34) uint8, ok (N,) bool) in input
    row order."""
    N = len(blk_types)
    tsel = _MIX_TSEL_OF[np.asarray(blk_types, np.int64)]
    if (tsel < 0).any():
        raise ValueError("row type outside the mixed decode's variant table")
    idx = np.where(np.asarray(blk_types) == P.TPSAP_T_SB1, 0,
                   np.asarray(scramb_idx)).astype(np.int64)
    d = _Dispatch(ks_table.device)
    out = np.zeros((N, _T1_BYTES + 1), np.uint8)
    pend = []
    si = np.nonzero((tsel == _MIX_SB1) | (tsel == _MIX_NDB))[0]
    for rows in _chunks(si):
        pend.append((rows, True, d.fetch(_decode_short_packed(
            d.up(t5p[rows, :_SHORT_T5_BYTES]), ks_table, d.up(idx[rows]),
            d.up(tsel[rows])))))
    for rows in _chunks(np.nonzero(tsel == _MIX_SCHF)[0]):
        pend.append((rows, False, d.fetch(_decode_schf_packed(
            d.up(t5p[rows]), ks_table, d.up(idx[rows])))))
    for rows in _chunks(np.nonzero(tsel == _MIX_BBK)[0]):
        pend.append((rows, False, d.fetch(_decode_bbk_packed(
            d.up(t5p[rows, :4]), ks_table, d.up(idx[rows])))))
    d.wait()
    for rows, short, r in pend:
        r = r.numpy()
        if short:
            out[rows, :_SHORT_T1_BYTES] = r[:, :_SHORT_T1_BYTES]
            out[rows, _T1_BYTES] = r[:, _SHORT_T1_BYTES]
        else:
            out[rows] = r
    return out[:, :_T1_BYTES], out[:, _T1_BYTES].astype(bool)
