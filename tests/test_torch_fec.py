"""The port's Viterbi and FEC decoders are bit-exact against tetra_tpu.rx.fec
on real encoded rows (clean and with bit errors) and on random rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu import params as P
from tetra_tpu.rx import fec as JF
from tetra_tpu.rx import viterbi as JV
from tetra_tpu.tx import fec_enc
from tetra_tpu_torch.rx import fec as TF
from tetra_tpu_torch.rx import viterbi as TV
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

SCR = P.scramb_get_init(262, 1234, 7)
TYPES = ((P.TPSAP_T_SB1, 120), (P.TPSAP_T_BBK, 30), (P.TPSAP_T_SB2, 216),
         (P.TPSAP_T_NDB, 216), (P.TPSAP_T_SCH_F, 432))


@pytest.fixture(scope="module")
def rows():
    """30 type-5 rows of every downlink type: random, clean encoded, and
    encoded with 2 or 6 flipped bits.  Returns (t5 (N, 432), types,
    table slots, scrambling codes, ks table)."""
    rng = np.random.default_rng(9)
    t5, types, idx = [], [], []
    for rep in range(6):
        for bt, t345 in TYPES:
            _, _, _, t1, _, _ = P.BLK_PARAMS[bt]
            if rep == 0:
                bits = rng.integers(0, 2, t345).astype(np.uint8)
            else:
                s = P.SCRAMB_INIT if bt == P.TPSAP_T_SB1 else SCR
                bits = fec_enc.encode_block(
                    rng.integers(0, 2, t1).astype(np.uint8), bt, s)
                if rep >= 4:
                    bits[rng.choice(t345, 2 if rep == 4 else 6,
                                    replace=False)] ^= 1
            pad = np.zeros(432, np.uint8)
            pad[:t345] = bits
            t5.append(pad)
            types.append(bt)
            idx.append(0 if bt == P.TPSAP_T_SB1 else 1)
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = JF.keystream(P.SCRAMB_INIT, 432)
    ks[1] = JF.keystream(SCR, 432)
    n = len(types)
    return (np.stack(t5), np.asarray(types), np.asarray(idx, np.int32),
            np.full(n, SCR, np.int64), ks)


@pytest.mark.parametrize("code,term,T", [
    pytest.param(code, term, T, id=f"{code}-{term}" + (f"-{T}" if T > 60
                                                       else ""))
    for T in (60, 144, 288)
    for code, term in (("cch", "zero"), ("cch", "truncate"), ("tch", "zero"),
                       ("tch", "truncate"))])
def test_viterbi_matches_jax(code, term, T):
    """The plain twin against the reference on {-1, 0, +1} rows; at the
    typed FEC's 144 and 288 steps each row's tail (up to half the row) is
    padded at the mixed decode's pad amplitude, as shorter blocks are."""
    rng = np.random.default_rng(len(code) + len(term) + T - 60)
    n = 4 if code == "cch" else 3
    soft = rng.choice([-1.0, 0.0, 1.0], size=(24, T, n)).astype(np.float32)
    if T > 60:
        for row, tail in zip(soft, rng.integers(0, T // 2, len(soft))):
            row[T - tail:] = TF._MIX_PAD_AMP
    ref = np.asarray(JV.viterbi_decode(jnp.asarray(soft), code, term))
    got = TV.viterbi_decode(torch.from_numpy(soft), code, term).numpy()
    np.testing.assert_array_equal(got, ref)


def test_viterbi_decodes_encoded_blocks():
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (6, 80)).astype(np.uint8)
    info[:, -4:] = 0                                # zero tail
    coded = np.stack([fec_enc.conv_encode(b) for b in info])
    soft = (1.0 - 2.0 * coded.astype(np.float32)).reshape(6, 80, 4)
    soft[:, ::7, 1] = 0.0                           # erasures
    got = TV.viterbi_decode(torch.from_numpy(soft), "cch").numpy()
    np.testing.assert_array_equal(got, info)


def test_decode_rows_typed_packed_matches_jax(rows):
    t5, types, idx, _, ks = rows
    t5p = np.packbits(t5, axis=1)
    want_t1, want_ok = JF.decode_rows_typed_packed(t5p, types, idx,
                                                   jnp.asarray(ks))
    got_t1, got_ok = TF.decode_rows_typed_packed(t5p, types, idx,
                                                 torch.from_numpy(ks))
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_t1, want_t1)
    assert 0 < want_ok.sum() < len(want_ok)


def test_decode_rows_mixed_matches_jax(rows):
    """The port's one fleet program decodes as the reference's unpacked
    decode_rows_mixed, on each row's packed type-1 bytes (a short row's
    whole 16-byte head)."""
    t5, types, idx, scr, ks = rows
    want_t1, want_ok = JF.decode_rows_mixed(t5, types, scr)
    want_t1 = np.packbits(np.pad(want_t1, ((0, 0), (0, 4))), axis=1)
    got_t1, got_ok = TF.decode_rows_typed_packed(
        np.packbits(t5, axis=1), types, idx, torch.from_numpy(ks))
    np.testing.assert_array_equal(got_ok, want_ok)
    for r, bt in enumerate(types):
        nb = 34 if bt == P.TPSAP_T_SCH_F else (
            2 if bt == P.TPSAP_T_BBK else 16)
        np.testing.assert_array_equal(got_t1[r, :nb], want_t1[r, :nb])


def test_crc_and_rm_match_jax():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (40, 140)).astype(np.uint8)
    good = np.stack([fec_enc.append_crc16(b[:124]) for b in bits[:20]])
    allb = np.concatenate([good, bits[20:]])
    np.testing.assert_array_equal(
        TF.crc16_check(torch.from_numpy(allb)).numpy(),
        np.asarray(JF.crc16_check(jnp.asarray(allb))))
    cw = rng.integers(0, 2, (64, 30)).astype(np.uint8)
    ti, tok = TF.rm3014_decode(torch.from_numpy(cw))
    ji, jok = JF.rm3014_decode(jnp.asarray(cw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


ALL_TYPES = (P.TPSAP_T_SB1, P.TPSAP_T_SB2, P.TPSAP_T_NDB, P.TPSAP_T_SCH_HU,
             P.TPSAP_T_SCH_F, P.TPSAP_T_BBK)


def _typed_rows(bt, n, seed):
    """n type-5 rows of block type bt: random, clean encoded under two
    cells' codes, and encoded with 1 or 5 flipped bits."""
    rng = np.random.default_rng(seed)
    _, t345, _, t1, _, _ = P.BLK_PARAMS[bt]
    codes = (SCR, P.scramb_get_init(901, 42, 11))
    rows, scr = [], []
    for i in range(n):
        s = codes[i % 2]
        if i % 4 == 0:
            bits = rng.integers(0, 2, t345).astype(np.uint8)
        else:
            bits = fec_enc.encode_block(
                rng.integers(0, 2, t1).astype(np.uint8), bt,
                P.SCRAMB_INIT if bt == P.TPSAP_T_SB1 else s)
            if i % 4 == 3:
                bits[rng.choice(t345, 1 + 4 * (i % 8 == 7),
                                replace=False)] ^= 1
        rows.append(bits)
        scr.append(s)
    return np.stack(rows), scr


@pytest.mark.parametrize("bt", ALL_TYPES)
def test_decode_block_matches_jax(bt):
    """One scrambling code for the batch, and one per row."""
    t5, scr = _typed_rows(bt, 12, bt)
    for code in (SCR, scr):
        want_t1, want_ok = JF.decode_block(jnp.asarray(t5), bt, code)
        got_t1, got_ok = TF.decode_block(torch.from_numpy(t5), bt, code)
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(got_t1.numpy(), np.asarray(want_t1))
        assert got_t1.shape == (12, P.BLK_PARAMS[bt][3])
    assert 0 < int(got_ok.sum()) < 12


def test_descramble_and_deinterleave_match_jax():
    bits = np.random.default_rng(2).integers(0, 2, (5, 216)).astype(np.uint8)
    np.testing.assert_array_equal(
        TF.descramble(torch.from_numpy(bits), SCR).numpy(),
        np.asarray(JF.descramble(jnp.asarray(bits), SCR)))
    np.testing.assert_array_equal(
        TF.deinterleave(torch.from_numpy(bits), 101).numpy(),
        np.asarray(JF.deinterleave(jnp.asarray(bits), 101)))


@pytest.mark.parametrize("with_hu", [False, True])
def test_decode_blocks_mixed_matches_jax(with_hu):
    """Every downlink type in one batch with per-row codes (SB1 rows take
    SCRAMB_INIT whatever code they carry); with an SCH/HU row the batch
    takes the per-type fallback."""
    blocks = []
    for bt in ALL_TYPES:
        if bt == P.TPSAP_T_SCH_HU and not with_hu:
            continue
        t5, scr = _typed_rows(bt, 6, 10 + bt)
        blocks += [(bt, r, s) for r, s in zip(t5, scr)]
    order = np.random.default_rng(4).permutation(len(blocks))
    blocks = [blocks[i] for i in order]
    want = JF.decode_blocks_mixed(blocks)
    got = TF.decode_blocks_mixed(blocks, "cpu")
    assert len(got) == len(want)
    for (gt, gok), (wt, wok), (bt, _, _) in zip(got, want, blocks):
        assert gok == wok and isinstance(gok, bool)
        np.testing.assert_array_equal(gt, np.asarray(wt))
        assert len(gt) == P.BLK_PARAMS[bt][3]
    assert 0 < sum(ok for _, ok in got) < len(got)
