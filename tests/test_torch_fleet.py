"""The port's fleet engine and pipelined fleet receiver against tetra_tpu's
on the CPU: the port's one packed FEC program, in one pass and chunked,
against each of the reference's packed programs (split, typed, mixed) and
its unpacked fallback at their bucket sizes; FleetEngine (worker threads,
link profile, accessors, more than 15 cells in a batch) against the
reference's engine on each of its FEC programs; and TetraReceiver's
superblock pipeline (link_profile="pcie") with its one-superblock lag and
flush_wideband().  Each test is the counterpart of one in
tests/test_fleet.py (named in its docstring); JAX runs on the CPU.

The receivers run on 8 carriers of two cells (200 slots, 25 dB SNR, 120 Hz
CFO), fed one wb_k = 2 superblock a call; on this air the port's plain
versions and the reference's XLA twins decode identically, so the
observables are compared for equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu import params as P
from tetra_tpu.rx import demod_fast as JDF
from tetra_tpu.rx import fec as JF
from tetra_tpu.rx.fleet import FleetEngine as JaxEngine
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell, fec_enc
from tetra_tpu_torch.rx import demod_fast as TDF
from tetra_tpu_torch.rx import fec as TF
from tetra_tpu_torch.rx.fleet import FleetEngine
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tests.test_torch_receiver_channel import (  # noqa: F401
    cell_pair_air, one_torch_thread)

N, KW = 8, 2
SLOTS = 200
FLUSHED_AT = {2, 4}          # mid-stream flushes of the pcie receiver
CKPT_AT = 3                  # a checkpoint taken with a superblock pending
START = TdmaTime(mn=1, fn=17, tn=4)
TYPES = ((P.TPSAP_T_SB1, 120), (P.TPSAP_T_BBK, 30), (P.TPSAP_T_SB2, 216),
         (P.TPSAP_T_NDB, 216), (P.TPSAP_T_SCH_F, 432))


# -- the packed FEC --------------------------------------------------------


@pytest.fixture(scope="module")
def packed_rows():
    """30 packed type-5 rows, every downlink type: random ones, and rows
    encoded for the table's two cells, clean or with 2 flipped bits;
    returns (t5p, types, idx, ks)."""
    rng = np.random.default_rng(10)
    scr = P.scramb_get_init(262, 4321, 3)
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = JF.keystream(P.SCRAMB_INIT, 432)
    ks[1] = JF.keystream(scr, 432)
    t5m, types, idx = [], [], []
    for rep in range(6):
        for bt, t345 in TYPES:
            bits = rng.integers(0, 2, t345).astype(np.uint8)
            if rep:
                t1 = P.BLK_PARAMS[bt][3]
                bits = fec_enc.encode_block(
                    rng.integers(0, 2, t1).astype(np.uint8), bt,
                    P.SCRAMB_INIT if bt == P.TPSAP_T_SB1 else scr)
                if rep >= 4:
                    bits[rng.choice(t345, 2, replace=False)] ^= 1
            pad = np.zeros(432, np.uint8)
            pad[:t345] = bits
            t5m.append(np.packbits(pad))
            types.append(bt)
            idx.append(0 if bt == P.TPSAP_T_SB1 else 1)
    return (np.stack(t5m), np.asarray(types), np.asarray(idx, np.int32), ks)


def _both(name, rows, **kw):
    t5p, types, idx, ks = rows
    want = getattr(JF, name)(t5p, types, idx, jnp.asarray(ks), **kw)
    got = getattr(TF, name)(t5p, types, idx, torch.from_numpy(ks))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    return got


# the leading bytes of a row's packed type-1 bits that every program
# decodes alike (a short row's whole 16-byte head)
T1_BYTES = {P.TPSAP_T_SB1: 16, P.TPSAP_T_BBK: 2, P.TPSAP_T_SB2: 16,
            P.TPSAP_T_NDB: 16, P.TPSAP_T_SCH_F: 34}


def _assert_same_t1(got, want, types):
    """Equal CRC flags, and equal type-1 bytes row by row."""
    np.testing.assert_array_equal(got[1], want[1])
    for r, bt in enumerate(types):
        nb = T1_BYTES[int(bt)]
        np.testing.assert_array_equal(got[0][r, :nb], want[0][r, :nb])


def _chunk_at(monkeypatch, rows: int) -> None:
    """Chunk the port's decode at `rows` rows a pass (0: one pass)."""
    if rows:
        monkeypatch.setattr(TF, "_MAX_CHUNK_ROWS", rows)


@pytest.mark.parametrize("cch, bbk", [(0, 0), (8, 4)])
def test_decode_rows_split_packed_matches_mixed_and_jax(packed_rows, cch,
                                                        bbk, monkeypatch):
    """test_fleet.py:242: the port's one program, in one pass or chunked
    at the CCH bucket, decodes as the reference's split programs
    (full-width CCH, RM(30,14)), unchunked and chunked over buckets smaller
    than the batch."""
    t5p, types, idx, ks = packed_rows
    _chunk_at(monkeypatch, cch)
    want = JF.decode_rows_split_packed(t5p, types, idx, jnp.asarray(ks),
                                       cch_bucket=cch, bbk_bucket=bbk)
    got = TF.decode_rows_typed_packed(t5p, types, idx, torch.from_numpy(ks))
    _assert_same_t1(got, want, types)
    assert 0 < got[1].sum() < len(types)


@pytest.mark.parametrize("bucket", [0, 8, 21])
def test_decode_rows_mixed_packed_chunking(bucket, monkeypatch):
    """test_fleet.py:468: the port's program chunked by _MAX_CHUNK_ROWS
    decodes as in one pass, and as the reference's mixed program chunked
    by min_bucket."""
    rng = np.random.default_rng(13)
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = JF.keystream(P.SCRAMB_INIT, 432)
    n = 21
    rows = (rng.integers(0, 256, (n, 54)).astype(np.uint8),
            rng.integers(0, 4, n).astype(np.int64), np.zeros(n, np.int32))
    one = TF.decode_rows_typed_packed(*rows, torch.from_numpy(ks))
    _chunk_at(monkeypatch, bucket)
    got = TF.decode_rows_typed_packed(*rows, torch.from_numpy(ks))
    want = JF.decode_rows_mixed_packed(*rows, jnp.asarray(ks),
                                       min_bucket=bucket)
    _assert_same_t1(got, want, rows[1])
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


@pytest.mark.parametrize("short, schf, bbk", [(0, 0, 0), (8, 4, 4),
                                              (5, 1, 3)])
def test_decode_rows_typed_packed_matches_mixed_and_jax(packed_rows, short,
                                                        schf, bbk,
                                                        monkeypatch):
    """test_fleet.py:488: the port's program, in one pass or chunked at
    the short bucket, equals the reference's typed decode at each bucket
    triple byte for byte, and the mixed program (_decode_mixed_packed) on
    each row's type-1 bytes."""
    _chunk_at(monkeypatch, short)
    got = _both("decode_rows_typed_packed", packed_rows, short_bucket=short,
                schf_bucket=schf, bbk_bucket=bbk)
    t5p, types, idx, ks = packed_rows
    t = torch.from_numpy
    mixed = TF._decode_mixed_packed(t(t5p), t(ks), t(idx),
                                    t(TF._MIX_TSEL_OF[types])).numpy()
    _assert_same_t1(got, (mixed[:, :34], mixed[:, 34].astype(bool)), types)


@pytest.mark.parametrize("min_bucket", [0, 64])
def test_decode_rows_mixed_min_bucket(packed_rows, min_bucket):
    """The port's program on packed rows decodes as the reference's
    unpacked decode_rows_mixed at its min_bucket (a padding size there)."""
    t5p, types, idx, ks = packed_rows
    t5 = np.unpackbits(t5p, axis=1)[:, :432]
    scr = np.full(len(types), P.scramb_get_init(262, 4321, 3), np.int64)
    t1, ok = JF.decode_rows_mixed(t5, types, scr, min_bucket=min_bucket)
    want = (np.packbits(np.pad(t1, ((0, 0), (0, 4))), axis=1), ok)
    got = TF.decode_rows_typed_packed(t5p, types, idx, torch.from_numpy(ks))
    _assert_same_t1(got, want, types)


# -- the fleet engine -------------------------------------------------------


def _pack_words(dibm, valid, K, n_chunks):
    """The pack_cycle_tc words of (C, K*T) dibits and per-chunk-prefix
    valid flags, T = n_chunks * 32: (K*(2*n_chunks + ceil(n_chunks/4)), C)
    int32."""
    C = dibm.shape[0]
    T = n_chunks * 32
    cnt_words = -(-n_chunks // 4)
    rows = []
    for j in range(K):
        d = dibm[:, j * T:(j + 1) * T].T.astype(np.int64)
        v = valid[:, j * T:(j + 1) * T].T.astype(np.int64)
        sym = (d & 3).reshape(T // 16, 16, C)
        rows.append((sym << (2 * np.arange(16))[None, :, None]).sum(1))
        counts = np.concatenate([v.reshape(n_chunks, 32, C).sum(1),
                                 np.zeros((cnt_words * 4 - n_chunks, C),
                                          np.int64)])
        wc = counts.reshape(cnt_words, 4, C)
        rows.append((wc << (8 * np.arange(4))[None, :, None]).sum(1))
    return np.concatenate(rows).astype(np.uint32).view(np.int32)


def _assert_same_engine(a, b, C):
    """Every per-channel observable of two engines (either package)."""
    for c in range(C):
        x, y = a.chan(c), b.chan(c)
        assert x.state == y.state, c
        assert (x.start_bitnum, x.buf_len) == (y.start_bitnum, y.buf_len), c
        assert bytes(x.buf[:x.buf_len]) == bytes(y.buf[:y.buf_len]), c
        assert bytes(x.mac) == bytes(y.mac), c
        assert a.crc_counts(c) == b.crc_counts(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
        assert str(a.phy_time(c)) == str(b.phy_time(c)), c
        assert a.lock_losses(c) == b.lock_losses(c), c
    assert a.state_bytes() == b.state_bytes()


@pytest.fixture(scope="module")
def voice_feed():
    """test_fleet.py:539's feed: 3 cells with traffic (SCH-F) on timeslot
    2, 30 x 255 symbols of packed bytes."""
    C, T = 3, 30 * 255
    streams = []
    for c in range(C):
        vslots = {2: (lambda f=c: np.full(274, f % 2, np.uint8))}
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=50 + c, cc=2 + c), 2 * T // 255 + 2,
            start=START, voice_slots=vslots)
        streams.append(bits)
    return np.stack([((s[0::2] << 1) | s[1::2]).astype(np.uint8)[:T] | 0x80
                     for s in streams])


@pytest.mark.parametrize("kind", ["split", "mixed"])
def test_fleet_engine_fec_programs_match_typed_and_jax(voice_feed, kind):
    """test_fleet.py:539: the port's engine, on its one FEC program, ends
    in the state of the reference's engine on its split (or its mixed)
    program."""
    kw = dict(split_fec=True) if kind == "split" else dict(typed_fec=False)
    C = voice_feed.shape[0]
    port = FleetEngine(C, "cpu")
    ref = JaxEngine(C, **kw)
    assert not ref.typed_fec and ref.split_fec == (kind == "split")
    for i in range(0, voice_feed.shape[1], 2400):
        for f in (port, ref):
            f.process_packed(voice_feed[:, i:i + 2400])
    _assert_same_engine(port, ref, C)
    for c in range(C):
        assert port.locked(c) and port.crc_counts(c)[0] > 0, c


@pytest.mark.parametrize("entry", ["process_packed_cycles",
                                   "process_packed2"])
def test_fleet_engine_past_fifteen_cells_matches_jax(monkeypatch, entry):
    """17 carriers of 17 cells: once locked, a batch holds 17 scrambling
    codes besides SCRAMB_INIT.  The reference's engine decodes it through
    its unpacked fallback (rx/fec.decode_rows_mixed), the port's through
    its one program; both end in the same state, on either feed entry."""
    C, K, n_chunks = 17, 4, 75
    T = n_chunks * 32
    streams = []
    for c in range(C):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=60 + c, cc=1 + c),
            2 * (K * T) // 255 + 4, start=START)
        streams.append(((bits[0::2] << 1) | bits[1::2]).astype(np.uint8))
    dibm = np.stack([s[:K * T] for s in streams])
    packed = (dibm & 3) | 0x80
    feed = {"process_packed_cycles": lambda f: f.process_packed_cycles(
                np.stack([packed[:, j * T:(j + 1) * T]
                          for j in range(1, K)])),
            "process_packed2": lambda f: f.process_packed2(
                _pack_words(dibm[:, T:], np.ones_like(dibm[:, T:], bool),
                            K - 1, n_chunks), K - 1, n_chunks)}[entry]
    codes, fallbacks = [], []
    decode, mixed = TF.decode_rows_typed_packed, JF.decode_rows_mixed

    def spy_decode(t5p, blk_types, scramb_idx, ks_table):
        codes.append(len(np.unique(scramb_idx[scramb_idx > 0])))
        assert ks_table.shape[0] > int(scramb_idx.max())
        return decode(t5p, blk_types, scramb_idx, ks_table)

    def spy_mixed(*args, **kw):
        fallbacks.append(len(args[0]))
        return mixed(*args, **kw)

    monkeypatch.setattr(TF, "decode_rows_typed_packed", spy_decode)
    monkeypatch.setattr(JF, "decode_rows_mixed", spy_mixed)
    port, ref = FleetEngine(C, "cpu"), JaxEngine(C)
    n = set()
    for f in (port, ref):
        f.process_packed(packed[:, :T])
        n.add(feed(f))
    assert len(n) == 1 and n.pop() > 0
    assert max(codes) >= 16 and fallbacks, (codes, fallbacks)
    _assert_same_engine(port, ref, C)
    assert len({port.scramb[c] for c in range(C)}) == C
    for c in range(C):
        assert port.locked(c) and port.crc_counts(c)[0] > 0, c


def test_fleet_threads_bitexact_and_accessors_match_jax():
    """test_fleet.py:571: the worker pool (threads=3 over 5 channels) and
    the sequential engine end in identical state on both feed entries,
    and so does the reference's engine: chan(c), phy_time(c),
    lock_losses(c) and the state blob included."""
    C, K, n_chunks = 5, 4, 75
    T = n_chunks * 32
    streams = []
    for c in range(C):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=60 + c, cc=1 + c),
            2 * (K * T) // 255 + 4, start=START)
        streams.append(((bits[0::2] << 1) | bits[1::2]).astype(np.uint8))
    dibm = np.stack([s[:K * T] for s in streams])
    packed = (dibm & 3) | 0x80
    words = _pack_words(dibm[:, T:], np.ones_like(dibm[:, T:], bool), K - 1,
                        n_chunks)
    seq = FleetEngine(C, "cpu", threads=1)
    par = FleetEngine(C, "cpu", threads=3)
    ref = JaxEngine(C, threads=1)
    assert (seq.threads, par.threads) == (1, 3)
    n = set()
    for f in (seq, par, ref):
        f.process_packed(packed[:, :T])
        n.add(f.process_packed2(words, K - 1, n_chunks))
    assert len(n) == 1 and n.pop() > 0
    _assert_same_engine(seq, par, C)
    _assert_same_engine(seq, ref, C)
    for c in range(C):
        assert seq.locked(c) and seq.crc_counts(c)[0] > 0, c
        assert seq.phy_time(c).mn > 0


def _shrink_rowbufs(engine, rows: int) -> None:
    """Give the engine a row buffer of `rows` rows, whatever its feed asks
    for (both packages' engines keep it in _cap, _t5 and _meta)."""
    width = {"_t5": (54, np.uint8), "_meta": (12, np.int64)}

    def ensure(K, T):
        engine._cap = rows
        for name, (cols, dtype) in width.items():
            setattr(engine, name, np.empty((rows, cols), dtype))
    engine._ensure_rowbufs = ensure


@pytest.mark.parametrize("entry", ["cycles", "superblock"])
def test_row_capacity_overflow_raises_as_in_jax(voice_feed, entry):
    """rx/fleet.py:339 and :363 of the reference: a feed that emits more
    rows than the engine's buffer holds (the native feed returns one row
    more than the buffer, fleet.cpp emit_block) stops before those rows
    are decoded or the next feed is given a negative capacity.  The
    reference asserts; the port raises RuntimeError.  Both engines get a
    4-row buffer and 3 cycles of 3 locked channels, through
    process_packed_cycles or process_packed2."""
    K, n_chunks = 3, 75
    T = n_chunks * 32
    cycles = np.stack([voice_feed[:, j * T:(j + 1) * T] for j in range(K)])
    words = _pack_words(voice_feed[:, :K * T] & 3,
                        np.ones((3, K * T), bool), K, n_chunks)
    feed = {"cycles": lambda f: f.process_packed_cycles(cycles),
            "superblock": lambda f: f.process_packed2(words, K, n_chunks)}
    for engine, err in ((FleetEngine(3, "cpu"), RuntimeError),
                        (JaxEngine(3), AssertionError)):
        _shrink_rowbufs(engine, 4)
        with pytest.raises(err, match="capacity overflow"):
            feed[entry](engine)
    # the same feeds fit the buffer the engine sizes itself
    whole = FleetEngine(3, "cpu")
    assert feed[entry](whole) > 4


@pytest.mark.parametrize("what", ["engine", "receiver"])
def test_no_native_mac_switch_stops_the_fleet_as_in_jax(monkeypatch, what):
    """TETRA_NO_NATIVE_MAC disables the native MAC, and with it the
    native-only fleet path: in both packages FleetEngine, and so a fleet
    receiver, raises RuntimeError (reference rx/fleet.py:86-87,
    :166-169), where the per-channel receiver runs on."""
    monkeypatch.setenv("TETRA_NO_NATIVE_MAC", "1")
    make = {"engine": (lambda: FleetEngine(8, "cpu"), lambda: JaxEngine(8)),
            "receiver": (
                lambda: TetraReceiver(wideband=8, fleet=True, device="cpu"),
                lambda: JaxReceiver(wideband=8, fleet=True, events=False))}
    for build in make[what]:
        with pytest.raises(RuntimeError, match="native fleet engine "
                           "unavailable"):
            build()
    assert TetraReceiver(wideband=8, device="cpu").fleet is None


@pytest.mark.parametrize("profile", ["tunnel", "pcie"])
@pytest.mark.parametrize("wideband, t50, wb_k", [(8, 6400, 2), (64, 1600, 4),
                                                 (0, 6400, 1)])
def test_receiver_engine_configuration_matches_jax(profile, wideband, t50,
                                                   wb_k):
    """The receiver passes its link profile to its engine as the reference
    does; "pcie" pipelines the superblocks (when wb_k > 1) and puts worker
    threads on every core, "tunnel" on every core but one."""
    kw = dict(wideband=wideband, t50=t50, wb_k=wb_k, fleet=True,
              link_profile=profile)
    if not wideband:
        kw["channels"] = 64
    got = TetraReceiver(device="cpu", **kw)
    ref = JaxReceiver(events=False, **kw)
    assert got.wb_pipeline == ref.wb_pipeline == (profile == "pcie"
                                                  and wb_k > 1)
    assert got.fleet.link_profile == ref.fleet.link_profile == profile
    cores = os.cpu_count()
    assert got.fleet.threads == (cores if profile == "pcie"
                                 else max(1, cores - 1))


def test_pcie_halves_the_typed_buckets_and_overrides():
    """link_profile is the one switch of the pipeline: "pcie" with wb_k > 1
    pipelines, nothing else does, and no wb_pipeline= argument is taken;
    TETRA_FLEET_THREADS and threads= override the profile's thread count,
    threads= first."""
    pcie = TetraReceiver(wideband=N, fleet=True, wb_k=KW, link_profile="pcie",
                         device="cpu")
    tun = TetraReceiver(wideband=N, fleet=True, wb_k=KW, device="cpu")
    assert pcie.wb_pipeline and not tun.wb_pipeline
    assert pcie.fleet.threads == tun.fleet.threads + (os.cpu_count() > 1)
    assert not TetraReceiver(wideband=N, fleet=True, link_profile="pcie",
                             device="cpu").wb_pipeline       # wb_k = 1
    with pytest.raises(TypeError, match="wb_pipeline"):
        TetraReceiver(wideband=N, fleet=True, wb_k=KW, wb_pipeline=True,
                      device="cpu")
    old = os.environ.get("TETRA_FLEET_THREADS")
    os.environ["TETRA_FLEET_THREADS"] = "2"
    try:
        assert FleetEngine(4, "cpu", link_profile="pcie").threads == 2
        assert FleetEngine(4, "cpu", threads=3).threads == 3
    finally:
        if old is None:
            del os.environ["TETRA_FLEET_THREADS"]
        else:
            os.environ["TETRA_FLEET_THREADS"] = old
    with pytest.raises(ValueError, match="link_profile"):
        FleetEngine(4, "cpu", link_profile="wifi")


@pytest.mark.parametrize("block_len", [1024, 4608, 6400])
def test_demod_fast_max_symbols_matches_jax(block_len):
    assert TDF.max_symbols(block_len) == JDF.max_symbols(block_len)


# -- the pipelined receiver ---------------------------------------------------


def _chunks(rx, wide):
    """The stream as one wb_k-superblock feed a call (test_fleet.py:612)."""
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    sb = KW * adv
    n = (len(wide) - (wl - adv)) // sb
    return [wide[s * sb:(s + 1) * sb + (wl - adv)][:sb] for s in range(n)]


def _counts(rx):
    return [rx.crc_counts(c) for c in range(N)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same superblock feeds into: the pcie receiver (flushed twice
    mid-stream, checkpointed once with a superblock pending), its tunnel
    twin and the reference's pipelined receiver; each flushed at the end.
    Also the CRC tallies of the pcie receiver and its twin after every
    feed."""
    wide = cell_pair_air(N, SLOTS)
    pcie = TetraReceiver(wideband=N, fleet=True, wb_k=KW, link_profile="pcie",
                         device="cpu")
    tunnel = TetraReceiver(wideband=N, fleet=True, wb_k=KW, device="cpu")
    ref = JaxReceiver(wideband=N, fleet=True, events=False, wb_k=KW,
                      wb_pipeline=True)
    chunks = _chunks(pcie, wide)
    ckpt = str(tmp_path_factory.mktemp("fleet") / "pending.npz")
    steps = []
    for s, chunk in enumerate(chunks):
        for rx in (pcie, tunnel, ref):
            rx.process_wideband(chunk)
        if s in FLUSHED_AT:
            pcie.flush_wideband()
            pcie.flush_wideband()
        if s == CKPT_AT:
            pcie.save_state(ckpt)
        steps.append((_counts(pcie), _counts(tunnel)))
    for rx in (pcie, tunnel, ref):
        rx.flush_wideband()
    return dict(pcie=pcie, tunnel=tunnel, ref=ref, steps=steps,
                chunks=chunks, ckpt=ckpt)


def _assert_same_receivers(a, b):
    for c in range(N):
        assert a.locked(c) == b.locked(c), c
        assert a.crc_counts(c) == b.crc_counts(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
        assert a.fleet.lock_losses(c) == b.fleet.lock_losses(c), c
    assert a.fleet.state_bytes() == b.fleet.state_bytes()


def test_pcie_profile_matches_tunnel_twin(runs):
    """test_fleet.py:702: the full pcie configuration (pipelined, worker
    threads on every core) decodes after flush exactly as its tunnel
    twin, which pipelines nothing."""
    pcie, tunnel = runs["pcie"], runs["tunnel"]
    assert pcie.wb_pipeline and not tunnel.wb_pipeline
    assert len(runs["chunks"]) >= 6
    _assert_same_receivers(pcie, tunnel)
    np.testing.assert_array_equal(pcie.sym_quality, tunnel.sym_quality)
    for c in range(N):
        assert pcie.locked(c), c
        assert pcie.display(c).mnc == 100 + c % 2, c
        assert pcie.crc_counts(c)[0] > 10 * max(1, pcie.crc_counts(c)[1]), c


def test_pipelined_matches_sync_and_jax_after_flush(runs):
    """test_fleet.py:431: the pipelined (pcie) receiver defers each
    superblock's decode by one feed; after flush_wideband() it equals the
    synchronous receiver, and the reference's pipelined receiver, on every
    channel."""
    piped, tunnel, ref = runs["pcie"], runs["tunnel"], runs["ref"]
    assert piped.wb_pipeline and ref.wb_pipeline
    _assert_same_receivers(piped, tunnel)
    _assert_same_receivers(piped, ref)
    np.testing.assert_allclose(piped.sym_quality, ref.sym_quality, atol=2e-3)


def test_pipelined_lag_contract_mid_stream(runs):
    """test_fleet.py:612: unflushed, the pcie receiver's CRC tallies equal
    its synchronous twin's one feed earlier; a flush (twice: idempotent)
    brings them level at once, and the one-feed lag resumes on the next
    feed; the last flush levels them."""
    prev = [(0, 0)] * N
    for s, (got, sync) in enumerate(runs["steps"]):
        assert got == (sync if s in FLUSHED_AT else prev), s
        prev = sync
    assert _counts(runs["pcie"]) == _counts(runs["tunnel"])


def test_checkpoint_with_a_pending_superblock_as_in_jax(runs):
    """A checkpoint taken while a superblock is pending does not flush,
    as in the reference: restored into either package and fed the rest of
    the stream, both decode the same, and both miss the pending
    superblock (fewer CRC passes than the uninterrupted receiver)."""
    got = TetraReceiver(wideband=N, fleet=True, wb_k=KW, link_profile="pcie",
                        device="cpu")
    ref = JaxReceiver(wideband=N, fleet=True, events=False, wb_k=KW,
                      wb_pipeline=True)
    for rx in (got, ref):
        rx.load_state(runs["ckpt"])
        for chunk in runs["chunks"][CKPT_AT + 1:]:
            rx.process_wideband(chunk)
        rx.flush_wideband()
    _assert_same_receivers(got, ref)
    whole = sum(ok for ok, _ in _counts(runs["pcie"]))
    assert sum(ok for ok, _ in _counts(got)) < whole


def test_cli_link_profile_pcie_matches_jax(tmp_path):
    """tetra_rx --fleet --wideband 4 --wb-k 2 --link-profile pcie runs the
    pipeline and prints the reference CLI's summary: neither CLI flushes
    at the end of the stream, so both leave out the last superblock."""
    from tests.test_torch_cli import last_json, run

    path = str(tmp_path / "wide.cf32")
    cell_pair_air(4, 150).astype(np.complex64).tofile(path)
    args = (path, "--wideband", 4, "--fleet", "--wb-k", KW,
            "--link-profile", "pcie", "--status-every", 100)
    got, ref = (last_json(run(pkg, "tetra_rx", *args))
                for pkg in ("tetra_tpu_torch", "tetra_tpu"))
    assert got == ref
    assert all(s["locked"] and s["mnc"] == 100 + s["channel"] % 2
               for s in got), got
