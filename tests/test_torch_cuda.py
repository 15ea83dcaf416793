"""Each CUDA kernel against its plain PyTorch version on the card, at small
and ragged shapes (channel counts that are not a multiple of the kernels'
block widths, a short block, the smallest filterbank).  chip_smoke.py
checks the main path's shapes; these tests check the edges.

Marked `cuda`: without a CUDA device every test skips.  This file imports
no jax, so it also runs on a GPU host that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tetra_tpu_torch import exact_float32
from tetra_tpu_torch.ops import chan_kernel as CK
from tetra_tpu_torch.ops import demod_kernel as DK
from tetra_tpu_torch.ops import fec_trellis as FT
from tetra_tpu_torch.ops import mm_kernel as MK
from tetra_tpu_torch.parallel import channelizer as CH
from tetra_tpu_torch.rx import demod_fast as DF
from tetra_tpu_torch.tx.wideband import heterogeneous_fleet_iq

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    exact_float32()
    return torch.device("cuda", 0)


def _maxerr(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("C, T", [(1, 512), (7, 512), (40, 512), (256, 512),
                                  (257, 512), (40, 64)])
def test_k1_matches_plain(dev, C, T):
    """One block of a heterogeneous fleet, cold state: channel counts that
    are not a multiple of the kernel's 2-channel blocks, and a one-group
    block (T = 64)."""
    xr, xi = heterogeneous_fleet_iq(1, C, T, seed=C)
    args = (torch.from_numpy(xr[0].T.copy()).to(dev),
            torch.from_numpy(xi[0].T.copy()).to(dev),
            torch.ones(C, device=dev), torch.zeros(C, device=dev),
            torch.full((C,), 0.02, device=dev),
            torch.zeros(64, C, device=dev), torch.zeros(64, C, device=dev))
    n0 = DK.agc_fll_rrc.launches
    k = DK.agc_fll_rrc(*args)
    assert DK.agc_fll_rrc.launches == n0 + 1
    p = DK.agc_fll_rrc_plain(*args)
    for i in (0, 1, 5, 6):
        assert _maxerr(k[i], p[i]) <= 2e-4, i
    for i in (2, 3, 4):
        assert _maxerr(k[i], p[i]) <= 1e-4, i


@pytest.mark.parametrize("C, T, odd", [
    (1, 256, False), (7, 256, False), (40, 256, False), (256, 256, False),
    (257, 256, False), (40, 256, True), (40, 320, False)])
def test_k2_matches_plain(dev, C, T, odd):
    """Stage 2 on the kernel's own stage-1 output of a fleet block (a few
    groups: too few for the loops' switches to amplify last-bit
    differences, so everything agrees closely).  Channel counts that are
    not a multiple of the kernel's 8-channel blocks; an odd chunk count
    (32-symbol groups, one symbol per lane); and T = 320, where the timing
    runs past T inside a group, so valid turns false mid-group."""
    xr, xi = heterogeneous_fleet_iq(1, C, T, seed=C + 1)
    mfr, mfi, *_ = DK.agc_fll_rrc(
        torch.from_numpy(xr[0].T.copy()).to(dev),
        torch.from_numpy(xi[0].T.copy()).to(dev),
        torch.ones(C, device=dev), torch.zeros(C, device=dev),
        torch.zeros(C, device=dev), torch.zeros(64, C, device=dev),
        torch.zeros(64, C, device=dev))
    st0 = torch.zeros(8, C, device=dev)
    st0[1] = DF._OMEGA_MIN + 0.5 * (DF._OMEGA_MAX - DF._OMEGA_MIN)
    tail = torch.zeros(7, C, device=dev)
    n_chunks = DF.n_chunks_for(T) - (1 if odd else 0)
    n0 = MK.mm_costas.launches
    k = MK.mm_costas(mfr, mfi, st0, n_chunks, tail_re=tail, tail_im=tail)
    assert MK.mm_costas.launches == n0 + 1
    p = MK.mm_costas_plain(mfr, mfi, st0, n_chunks, tail_re=tail,
                           tail_im=tail)
    assert torch.equal(k[3], p[3])
    v = p[3].bool()
    G = DF.K_SYM * (1 if odd else 2)
    per_group = v.reshape(-1, G, C)
    mixed = per_group.any(dim=1) & ~per_group.all(dim=1)
    if T == 320:
        assert bool(mixed.any()), "no group where valid turns false"
    assert torch.equal(k[2][v], p[2][v])
    for i in (0, 1, 4):
        assert _maxerr(k[i][v], p[i][v]) <= 1e-3, i
    # state rows [pos, omega, cphase, cfreq, ph2, prev_sym, 0, 0]; the two
    # phases are compared modulo 2 pi (a value at the wrap point may land
    # on either side of it)
    for r in (0, 1, 3, 5, 6, 7):
        assert _maxerr(k[5][r], p[5][r]) <= 1e-3, r
    for r in (2, 4):
        d = torch.remainder(k[5][r] - p[5][r] + np.pi, 2 * np.pi) - np.pi
        assert float(d.abs().max()) <= 1e-3, r
    lean = MK.mm_costas(mfr, mfi, st0, n_chunks, emit_syms=False,
                        tail_re=tail, tail_im=tail)
    for a, b in zip(lean, k[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_ch, t50", [
    (16, 800), (16, 775), (64, 800), (128, 800), (256, 775), (512, 400),
    (1024, 100), (48, 800)])
def test_front_end_matches_plain(dev, n_ch, t50):
    """K4, and K3 (K4 + resample) over two streamed blocks, with t50 on
    and off the reference's 800-row tile.  K4's FFT kernel at n_ch = 16 to
    1024: a radix-2 stage first at 128 and 512 (odd log2), 8 and 4 frames
    per block at 512 and 1024, a tail block at t50 = 775; n_ch = 48 takes
    the matrix-DFT kernel."""
    rng = np.random.default_rng(n_ch + t50)
    hop = n_ch // 2
    need = t50 + 2 * CH.TAPS_PER_BRANCH - 1
    z = [torch.from_numpy(rng.standard_normal((need, hop)).astype(
        np.float32)).to(dev) for _ in range(2)]
    yk, yp = CK.fold_dft(*z, n_ch), CK.fold_dft_plain(*z, n_ch)
    rms = float(torch.sqrt((yp[0] ** 2 + yp[1] ** 2).mean()))
    assert max(_maxerr(yk[0], yp[0]), _maxerr(yk[1], yp[1])) <= 1e-4 * rms
    if t50 % 25:
        return
    t36 = t50 * 18 // 25
    h0 = torch.zeros(CH.RS_TAPS_PER_PHASE - 1, n_ch, device=dev)
    hk = hp = (h0, h0)
    for _ in range(2):
        rk = CK.fold_dft_resample(*z, *hk, n_ch, t36)
        rp = CK.fold_dft_resample_plain(*z, *hp, n_ch, t36)
        hk, hp = rk[2:], rp[2:]
        for a, b in zip(rk, rp):
            assert _maxerr(a, b) <= 1e-4 * rms


@pytest.mark.parametrize("n_ch, t50", [
    (16, 25), (16, 775), (16, 6400), (48, 25), (48, 775), (48, 6400),
    (256, 25), (256, 775), (256, 6400), (16, 91025)])
def test_resample_matches_plain(dev, n_ch, t50):
    """K3's resample kernel alone, over two chained blocks, at the shapes
    of tests/test_torch_resample_plan.py: one group, a ragged last tile,
    masked lanes (C = 16, 48), and t36 = 65538 (the earlier kernel's grid
    refused t36 > 65535).  The tails are the input's last 23 rows."""
    rng = np.random.default_rng(n_ch + t50)
    t36 = t50 * 18 // 25
    pad = CH.RS_TAPS_PER_PHASE - 1
    h = [torch.from_numpy(rng.standard_normal((pad, n_ch)).astype(
        np.float32)).to(dev) for _ in range(2)]
    hk = hp = tuple(h)
    for _ in range(2):
        y = [torch.from_numpy(rng.standard_normal((t50, n_ch)).astype(
            np.float32)).to(dev) for _ in range(2)]
        n0 = CK.resample.launches
        rk = CK.resample(*y, *hk, t36)
        assert CK.resample.launches == n0 + 1
        rp = CH._resample_stream_block_fm(*y, *hp, t36)
        rms = float(torch.sqrt((rp[0] ** 2 + rp[1] ** 2).mean()))
        for a, b in zip(rk[:2], rp[:2]):
            assert a.shape == b.shape
            assert _maxerr(a, b) <= 1e-4 * rms
        for a, b in zip(rk[2:], y):
            assert torch.equal(a, b[-pad:])
        hk, hp = rk[2:], rp[2:]


@pytest.mark.parametrize("n_ch, t50", [(16, 800), (48, 775), (256, 6400)])
def test_k3_tails_are_k4_last_rows(dev, n_ch, t50):
    """K3's next-block history, written by its resample kernel, equals the
    last 23 rows of K4's output on the same input; one K3 call counts one
    launch on fold_dft and one on fold_dft_resample."""
    rng = np.random.default_rng(n_ch)
    hop, pad = n_ch // 2, CH.RS_TAPS_PER_PHASE - 1
    need = t50 + 2 * CH.TAPS_PER_BRANCH - 1
    z = [torch.from_numpy(rng.standard_normal((need, hop)).astype(
        np.float32)).to(dev) for _ in range(2)]
    h = torch.zeros(pad, n_ch, device=dev)
    n4, n3 = CK.fold_dft.launches, CK.fold_dft_resample.launches
    rk = CK.fold_dft_resample(*z, h, h, n_ch, t50 * 18 // 25)
    assert (CK.fold_dft.launches, CK.fold_dft_resample.launches) == (
        n4 + 1, n3 + 1)
    yk = CK.fold_dft(*z, n_ch)
    assert torch.equal(rk[2], yk[0][-pad:])
    assert torch.equal(rk[3], yk[1][-pad:])


@pytest.mark.parametrize("C, spread", [(40, 0.0), (257, 0.0), (40, 1500.0)])
def test_k2_layouts_agree(dev, C, spread):
    """K2 with its group window staged in shared memory and with the taps
    read directly from device memory gives identical outputs.  A channel's
    outputs depend on its own inputs only, so the channels run twice: as
    given, and with the last channel of every 8-channel block started
    FAR samples later, which widens each such block's window past the rows
    the kernel stages and sends the block to direct loads.  spread > 0
    starts the channels up to that many samples apart (~38 per channel: a
    block's window is ~410 rows), so the first run falls back too.  The
    direct run is held against the plain version on the first group,
    before any group sum: from a cold start a last-bit difference in a sum
    can flip the Costas error's sign on a near-zero symbol, and the
    channel then acquires along another path (ROADMAP Queue 3, acquisition
    basins)."""
    T, FAR = 3072, 1500.0
    xr, xi = heterogeneous_fleet_iq(1, C, T, seed=C + 2)
    mfr, mfi, *_ = DK.agc_fll_rrc(
        torch.from_numpy(xr[0].T.copy()).to(dev),
        torch.from_numpy(xi[0].T.copy()).to(dev),
        torch.ones(C, device=dev), torch.zeros(C, device=dev),
        torch.zeros(C, device=dev), torch.zeros(64, C, device=dev),
        torch.zeros(64, C, device=dev))
    st0 = torch.zeros(8, C, device=dev)
    st0[0] = torch.linspace(0.0, spread, C, device=dev)
    st0[1] = DF._OMEGA
    moved = torch.arange(C, device=dev) % 8 == 7
    st_far = st0.clone()
    st_far[0] += torch.where(moved, FAR, 0.0)
    tail = torch.zeros(7, C, device=dev)
    n_chunks = DF.n_chunks_for(T)
    base = MK.mm_costas(mfr, mfi, st0, n_chunks, tail_re=tail, tail_im=tail)
    far = MK.mm_costas(mfr, mfi, st_far, n_chunks, tail_re=tail,
                       tail_im=tail)
    for a, b in zip(base, far):
        assert torch.equal(a[:, ~moved], b[:, ~moved])
    p = MK.mm_costas_plain(mfr, mfi, st_far, n_chunks, tail_re=tail,
                           tail_im=tail)
    head = slice(0, 2 * DF.K_SYM)
    k1, p1 = [x[head] for x in far[:5]], [x[head] for x in p[:5]]
    assert torch.equal(k1[3], p1[3])
    v = p1[3].bool()
    assert torch.equal(k1[2][v], p1[2][v])
    for i in (0, 1, 4):
        assert _maxerr(k1[i][v], p1[i][v]) <= 1e-3, i


@pytest.mark.parametrize("n_ch", [48])
def test_mesh_superblock_1x1_matches_superblock_scan(dev, tmp_path, n_ch):
    """The mesh's superblock step on a 1x1 mesh (one gloo rank: K4, then
    the resample kernel alone, K1, K2 lean) against the single-card
    superblock (rx/receiver._wideband_step_scan: K3 in one call) at a
    ragged channel count (K4's matrix-DFT path, masked resample lanes),
    three superblocks of noise in a row: the packed words equal (rows
    [:-1]), the dist-sum row within 2e-3 relative; each step launches K4,
    the resample, K1 and K2 once a cycle."""
    import torch.distributed as dist

    from tetra_tpu_torch.parallel import mesh as M
    from tetra_tpu_torch.rx import receiver as R

    kw, t50 = 2, 800
    t36 = t50 * 18 // 25
    n_chunks = DF.n_chunks_for(t36)
    M.init_distributed("gloo", f"file://{tmp_path}/rendezvous", 1, 0, dev)
    try:
        mesh = M.make_mesh_2d(1, 1, dev)
        step, wide_len, _ = M.sharded_wideband_superblock_step(
            mesh, n_ch, t50_new=t50, kw=kw)
        state = M.sharded_wideband_demod_init(mesh, n_ch, dev)
        dstate, hr, hi = M.sharded_wideband_demod_init(mesh, n_ch, dev)
        rng = np.random.default_rng(n_ch)
        wrappers = (CK.fold_dft, CK.resample, DK.agc_fll_rrc, MK.mm_costas)
        for _ in range(3):
            wr, wi = (torch.from_numpy(rng.standard_normal(
                (kw, wide_len)).astype(np.float32)).to(dev)
                for _ in range(2))
            n0 = [w.launches for w in wrappers]
            state, out, health, c0 = step(state, wr, wi)
            assert [w.launches - n for w, n in zip(wrappers, n0)] == [kw] * 4
            dstate, ref, hr, hi = R._wideband_step_scan(
                dstate, wr, wi, hr, hi, n_ch, t36, n_chunks, False, kw)
            assert c0 == 0 and out.shape == ref.shape
            assert torch.equal(out[:-1], ref[:-1])
            d, r = out[-1].view(torch.float32), ref[-1].view(torch.float32)
            assert bool(((d - r).abs() <= 2e-3 * r.abs()).all())
            assert torch.allclose(health[1], r.sum(), rtol=1e-5)
    finally:
        dist.destroy_process_group()


def test_chunked_typed_fec_on_card_matches_cpu(dev, monkeypatch):
    """The typed packed FEC on the card, in one pass and chunked by
    _MAX_CHUNK_ROWS (pinned uploads, fetches on the copy stream), equals
    the CPU's decode, with one trellis kernel launch a convolutional-coded
    chunk."""
    from tetra_tpu_torch import params as P
    from tetra_tpu_torch.rx import fec as FEC
    from tetra_tpu_torch.tx import fec_enc

    rng = np.random.default_rng(4)
    scr = P.scramb_get_init(262, 1234, 7)
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = FEC.keystream(P.SCRAMB_INIT, 432)
    ks[1] = FEC.keystream(scr, 432)
    t5, types = [], []
    for bt in (P.TPSAP_T_SB1, P.TPSAP_T_NDB, P.TPSAP_T_SCH_F,
               P.TPSAP_T_BBK) * 40:
        t1 = P.BLK_PARAMS[bt][3]
        bits = fec_enc.encode_block(rng.integers(0, 2, t1).astype(np.uint8),
                                    bt, P.SCRAMB_INIT if bt == P.TPSAP_T_SB1
                                    else scr)
        bits[rng.integers(0, len(bits), 3)] ^= 1
        pad = np.zeros(432, np.uint8)
        pad[:len(bits)] = bits
        t5.append(np.packbits(pad))
        types.append(bt)
    t5p, types = np.stack(t5), np.asarray(types)
    idx = np.ones(len(types), np.int32)
    want = FEC.decode_rows_typed_packed(t5p, types, idx,
                                        torch.from_numpy(ks))
    # 80 SB1/NDB rows and 40 SCH-F rows: one trellis launch a chunk
    for rows, chunks in ((0, 2), (16, 5 + 3)):
        if rows:
            monkeypatch.setattr(FEC, "_MAX_CHUNK_ROWS", rows)
        n = FT.trellis.launches
        got = FEC.decode_rows_typed_packed(
            t5p, types, idx, torch.from_numpy(ks).to(dev))
        assert FT.trellis.launches == n + chunks
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert 0 < want[1].sum() < len(types)


def test_pipelined_matches_sync_on_card(dev):
    """8 carriers: the pcie receiver (superblock step on its side stream,
    output through pinned buffers) and its tunnel twin decode
    the same staged windows bit-equal after flush_wideband(); every kernel
    of the pcie receiver's step, and its packing's torch ops, go to its
    side stream, and its FEC's trellis kernels to the caller's stream,
    where the FEC runs."""
    from tetra_tpu_torch.ops import _build
    from tetra_tpu_torch.rx import fec as FEC
    from tetra_tpu_torch.rx import receiver as R
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    from tetra_tpu_torch.tx.wideband import cell_air, staged_windows

    n, k = 8, 2
    pcie, tun = (TetraReceiver(wideband=n, fleet=True, wb_k=k,
                               link_profile=p, device=dev)
                 for p in ("pcie", "tunnel"))
    assert pcie.wb_pipeline and not tun.wb_pipeline
    staged = staged_windows(cell_air(n, 2.5, 2), pcie._wb["advance"],
                            pcie._wb["wide_len"], k, dev)
    seen, in_fec = {False: [], True: []}, [False]
    stream_of, pack = _build.stream_of, R.pack_cycle_tc
    decode = FEC.decode_rows_typed_packed

    def spy_pack(*args):
        seen[False].append(torch.cuda.current_stream(dev).cuda_stream)
        return pack(*args)

    def spy_decode(*args, **kw):
        in_fec[0] = True
        try:
            return decode(*args, **kw)
        finally:
            in_fec[0] = False

    def spy_stream(t):
        seen[in_fec[0]].append(stream_of(t))
        return seen[in_fec[0]][-1]

    caller = torch.cuda.current_stream(dev).cuda_stream
    fec_launches = 0
    try:
        _build.stream_of, R.pack_cycle_tc = spy_stream, spy_pack
        FEC.decode_rows_typed_packed = spy_decode
        for sb in staged:
            seen[False].clear()
            seen[True].clear()
            pcie.process_wideband_staged(*sb)
            assert len(seen[False]) >= 4 * k and set(seen[False]) == {
                pcie._side.cuda_stream}
            assert set(seen[True]) <= {caller}
            fec_launches += len(seen[True])
            tun.process_wideband_staged(*sb)
    finally:
        _build.stream_of, R.pack_cycle_tc = stream_of, pack
        FEC.decode_rows_typed_packed = decode
    assert fec_launches > 0
    pcie.flush_wideband()
    tun.flush_wideband()
    assert pcie._side.cuda_stream != torch.cuda.default_stream(
        dev).cuda_stream
    for c in range(n):
        assert pcie.locked(c) == tun.locked(c), c
        assert pcie.crc_counts(c) == tun.crc_counts(c), c
        assert pcie.display(c).as_dict() == tun.display(c).as_dict(), c
    assert pcie.fleet.state_bytes() == tun.fleet.state_bytes()
    np.testing.assert_array_equal(pcie.sym_quality, tun.sym_quality)
    assert sum(pcie.locked(c) for c in range(n)) >= n - 1


def _ingest_air(rx, n_sb: int):
    """tests/torch_ingest.py's cf32 and cs16 of one air, exactly n_sb of
    rx's superblocks, and its irregular chunk lengths.  The helpers are
    imported from this file's directory, which pytest puts on sys.path
    (a `tests` package installed on the host would shadow `tests.`)."""
    from torch_ingest import chunk_sizes, quantized, stream_len
    from tetra_tpu_torch.tx.wideband import cell_air
    n = stream_len(rx, n_sb)
    fs = rx.wideband * 25_000
    cf32, cs16 = quantized(cell_air(rx.wideband, n / fs + 0.05, 8))
    return cf32[:n], cs16[:2 * n], chunk_sizes(rx._wb["advance"], rx.wb_k, n)


def test_host_feed_matches_staged_on_card(dev):
    """The device ring on the card: cf32 and cs16 fed in irregular chunks
    (one sample, a prime, one advance, several superblocks in one call,
    each longer than a pinned staging buffer) cut the staged windows bit
    for bit and decode bit-equal to the staged feed."""
    from torch_ingest import (Spy, assert_same_decode, assert_same_packed,
                              assert_same_windows, chunks)
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    from tetra_tpu_torch.tx.wideband import staged_windows

    n, k, n_sb = 16, 2, 8
    rxs = [TetraReceiver(wideband=n, fleet=True, wb_k=k, device=dev)
           for _ in range(3)]
    spies = [Spy(rx) for rx in rxs]
    cf32, cs16, sizes = _ingest_air(rxs[0], n_sb)
    for chunk in chunks(cf32, sizes):
        rxs[0].process_wideband(chunk)
    for chunk in chunks(cs16, sizes):
        rxs[1].process_wideband(chunk)
    for sb in staged_windows(cf32, rxs[2]._wb["advance"],
                             rxs[2]._wb["wide_len"], k, dev, count=n_sb):
        rxs[2].process_wideband_staged(*sb)
    assert rxs[2]._wb["ring"] is None
    for rx, spy in zip(rxs[:2], spies[:2]):
        assert rx._wb["ring"].device == dev
        assert_same_windows(spy.windows, spies[2].windows)
        assert_same_packed(spy.packed, spies[2].packed)
        assert_same_decode(rx, rxs[2])
        assert rx.fleet.state_bytes() == rxs[2].fleet.state_bytes()
    assert sum(rxs[0].locked(c) for c in range(n)) == n


def test_pipelined_host_feed_matches_sync_on_card(dev):
    """The pcie receiver (wb_pipeline) host-fed one advance a call, each
    call behind a device sleep on the caller's stream, so the ring's
    copies queue while the host goes on writing its pinned staging
    buffers: after flush_wideband() it decodes bit-equal to the tunnel
    receiver fed the same chunks, so no staging buffer was rewritten
    before its copy landed."""
    from torch_ingest import (Spy, assert_same_decode, assert_same_packed,
                              chunks)
    from tetra_tpu_torch.rx.receiver import TetraReceiver

    n, k, n_sb = 8, 2, 6
    pcie, tun = (TetraReceiver(wideband=n, fleet=True, wb_k=k,
                               link_profile=p, device=dev)
                 for p in ("pcie", "tunnel"))
    assert pcie.wb_pipeline and not tun.wb_pipeline
    # no window copies on the pcie side: they would wait for the copies
    spy_p, spy_t = Spy(pcie, windows=False), Spy(tun, windows=False)
    cf32, _, _ = _ingest_air(pcie, n_sb)
    adv = pcie._wb["advance"]
    sizes = [adv] * (len(cf32) // adv) + [len(cf32) % adv]
    for chunk in chunks(cf32, sizes):
        torch.cuda._sleep(20_000_000)
        pcie.process_wideband(chunk)
        tun.process_wideband(chunk)
    pcie.flush_wideband()
    tun.flush_wideband()
    assert len(spy_p.packed) == len(spy_t.packed) == n_sb
    assert_same_packed(spy_p.packed, spy_t.packed)
    assert_same_decode(pcie, tun)
    assert pcie.fleet.state_bytes() == tun.fleet.state_bytes()


@pytest.mark.parametrize("R, T", [(1, 112), (129, 112), (300, 38)])
def test_speech_trellis_kernel_matches_plain(dev, R, T):
    """The speech trellis kernel against its plain version: noisy soft
    rows (quantised to 1/16 within +-2, some punctured), half of them
    truncated, bit for bit; and the voice monitor's whole batched decode
    of slots and halves, card against CPU."""
    from tetra_tpu_torch.ops import speech_kernel as SK
    from tetra_tpu_torch.voice import channel as vc
    from tetra_tpu_torch.voice.speech_batch import decode_speech
    rng = np.random.default_rng(R + T)
    x = np.clip(np.round((rng.choice([-1.0, 1.0], (R, T, 3))
                          + rng.normal(0, 0.8, (R, T, 3))) * 16), -32, 32) / 16
    x[rng.random((R, T, 3)) < 0.3] = 0.0
    x = torch.from_numpy(x.astype(np.float32))
    trunc = torch.from_numpy(rng.random(R) < 0.5)
    n = SK.trellis.launches
    got = SK.trellis(x.to(dev), trunc.to(dev)).cpu()
    assert SK.trellis.launches == n + 1
    assert torch.equal(got, SK.trellis_plain(x, trunc))
    frames = rng.integers(0, 2, (R, 2, 137)).astype(np.uint8)
    slots = np.stack([vc.encode_slot(f.reshape(-1)) for f in frames])
    halves = np.stack([vc.encode_half_slot(f[1]) for f in frames[:T]])
    flip = lambda b: 1.0 - 2.0 * (b ^ (rng.random(b.shape) < 0.03))
    soft = torch.from_numpy(flip(slots).astype(np.float32))
    hsoft = torch.from_numpy(flip(halves).astype(np.float32))
    on_card = [t.cpu() for t in decode_speech(soft.to(dev), hsoft.to(dev))]
    for a, b in zip(on_card, decode_speech(soft, hsoft)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("term", ["zero", "truncate"])
@pytest.mark.parametrize("R", [0, 1, 129])
@pytest.mark.parametrize("T", [80, 144, 288])
@pytest.mark.parametrize("code", ["cch", "tch"])
def test_fec_trellis_kernel_matches_plain(dev, code, T, R, term):
    """viterbi_decode on the card (one trellis kernel launch) against its
    plain twin _viterbi on the CPU, bit for bit: soft rows of {-1, 0, +1}
    whose tails (up to half the row) are padded at the mixed decode's pad
    amplitude, 4 mother bits a step (cch) and 3 (tch)."""
    from tetra_tpu_torch.rx import fec as FEC
    from tetra_tpu_torch.rx import viterbi as V
    rng = np.random.default_rng(R + T + len(code) + len(term))
    n = 4 if code == "cch" else 3
    x = rng.choice([-1.0, 0.0, 1.0], (R, T, n)).astype(np.float32)
    for row, tail in zip(x, rng.integers(0, T // 2, R)):
        row[T - tail:] = FEC._MIX_PAD_AMP
    x = torch.from_numpy(x)
    launches = FT.trellis.launches
    got = V.viterbi_decode(x.to(dev), code, term).cpu()
    assert FT.trellis.launches == launches + 1
    assert got.shape == (R, T) and got.dtype == torch.uint8
    assert torch.equal(got, V._viterbi(x, code == "tch", term == "truncate"))


@pytest.mark.parametrize("tables", ["parametric", "loaded"])
def test_acelp_synth_kernel_matches_host_bank(dev, tmp_path, tables):
    """AcelpCardBank (one acelp_synth launch a batch, the decoders kept on
    the card) against the host codec's AcelpBank, bit for bit: 70 calls
    of unequal lengths with keys up to 3,000 (the pool grows), halves,
    bad frames, withheld items (a call that opens with them, a call
    withheld through the first batch), three successive batches, with
    the codec's parametric quantizers and with random loaded tables;
    voice.acelp_rows counts each batch's items not withheld."""
    from acelp_batches import batches, random_tables
    from tetra_tpu_torch import spans as S
    from tetra_tpu_torch.ops import acelp_kernel as AK
    from tetra_tpu_torch.voice import acelp as TA
    if tables == "loaded":
        path = tmp_path / "tables.npz"
        np.savez(path, **random_tables(4))
        TA.load_codec_tables(str(path))
    try:
        host, card = TA.AcelpBank(threads=2), AK.AcelpCardBank(dev)
        for calls, frames, bfi, kind in batches(11, key_span=3000):
            launches = AK.synth.launches
            S.clear()
            got = card.decode(calls, frames, bfi, kind)
            S.close_superblock()
            assert AK.synth.launches == launches + 1
            assert S.records()["voice.acelp_rows"][-1] == (kind != 2).sum()
            want = host.decode(calls, frames, bfi, kind)
            assert np.array_equal(got, want), \
                f"{int((got != want).any(axis=1).sum())} of {len(calls)} " \
                f"items differ"
        made = card._pool.cpu().view(torch.int32)[:, -1]
        assert int(made.sum()) == len(host)
    finally:
        if tables == "loaded":
            TA.clear_codec_tables()


def test_fleet_voice_pcm_on_card_matches_host_bank(dev, tmp_path):
    """The fleet receiver's voice monitor on the card (16 carriers of
    voice_cell_air: voice on timeslot 2, steals of both kinds, TEA1 on
    cells 4-7 with the keys held): each superblock's take_voice() PCM
    equals a host AcelpBank fed the same rows in the same batches, and
    the card's synthesis launched once a superblock that had voice."""
    from tetra_tpu_torch import spans as S
    from tetra_tpu_torch.ops import acelp_kernel as AK
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    from tetra_tpu_torch.tx.wideband import cell_keystore, voice_cell_air
    from tetra_tpu_torch.voice import acelp as TA
    from tetra_tpu_torch.voice import monitor as VM

    keys = tmp_path / "keys.txt"
    keys.write_text(cell_keystore((4, 5, 6, 7)))
    wide, _ = voice_cell_air(16, 5.0, 8, keystore=str(keys),
                             encrypted=(4, 5, 6, 7))
    rx = TetraReceiver(wideband=16, fleet=True, wb_k=8, device=dev,
                       voice=True, keystore=str(keys))
    assert isinstance(rx.fleet.voice.bank, AK.AcelpCardBank)
    host = TA.AcelpBank(threads=2)
    S.clear()
    launches = AK.synth.launches
    adv = rx._wb["advance"]
    blocks = []
    for at in range(0, len(wide) - adv + 1, adv):
        rx.process_wideband(wide[at:at + adv])
        blocks += rx.take_voice()
    rows = withheld = 0
    for b in blocks:
        kind = np.where(b.crypt == VM.WITHHELD, 2, b.kind).astype(np.int8)
        want = host.decode(b.carrier * 4 + (b.timeslot - 1) % 4, b.frames,
                           b.bfi, kind)
        assert np.array_equal(b.pcm, want)
        rows += len(b)
        withheld += int((kind == 2).sum())
    assert rows > 200 and (np.concatenate([b.kind for b in blocks])
                           == VM.HALF).any()
    assert AK.synth.launches - launches == sum(len(b) > 0 for b in blocks)
    assert S.records()["voice.acelp_rows"].sum() == rows - withheld
