"""The fleet receiver's host ingest on the CPU: the ring process_wideband
writes each sample into once, and the windows it cuts from it.

One air on 16 carriers (every carrier a cell), superblocks of 2 windows,
fed four ways: as cf32 and as cs16 through process_wideband in irregular
chunks (one sample, a prime, one advance, several superblocks in one
call, ...), staged through process_wideband_staged, and to the JAX
package's process_wideband in the same chunks.  The port's three feeds
give the same windows, the same packed words for every superblock, and
the same locks, CRC tallies, display and sym_quality; the JAX package
cuts the same windows bit for bit (its packed words carry float32 sums
that its XLA twins round differently, so past the windows only its locks
and displays are compared).  Checkpoints keep the pending samples
as the numpy buffer did, restore into the ring and resume bit-equal, and
a JAX checkpoint loads into the ring."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tetra_tpu.rx import receiver as JR
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import cell_air, staged_windows
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401
from tests.torch_ingest import (Spy, assert_same_decode, assert_same_packed,
                                assert_same_windows, chunk_sizes, chunks,
                                quantized, stream_len)

N, KW, M = 16, 2, 8
CUT = 5                 # chunks fed before a checkpoint


def _port(wb_k=KW):
    return TetraReceiver(wideband=N, fleet=True, wb_k=wb_k, device="cpu")


@pytest.fixture(scope="module")
def air():
    """(cf32, cs16) of exactly M superblocks, and the chunk lengths."""
    rx = _port()
    cf32, cs16 = quantized(cell_air(N, 2.3, 8))
    n = stream_len(rx, M)
    assert len(cf32) >= n
    return cf32[:n], cs16[:2 * n], chunk_sizes(rx._wb["advance"], KW, n)


@pytest.fixture(scope="module")
def staged(air):
    rx = _port()
    spy = Spy(rx)
    for wr, wi in staged_windows(air[0], rx._wb["advance"],
                                 rx._wb["wide_len"], KW, "cpu", count=M):
        rx.process_wideband_staged(wr, wi)
    return rx, spy


@pytest.fixture(scope="module")
def jax_run(air, tmp_path_factory):
    """The JAX package fed the cf32 chunks, checkpointed after CUT chunks:
    (receiver, its windows, the checkpoint's path, superblocks run
    before it)."""
    rx = JR.TetraReceiver(wideband=N, fleet=True, events=False, wb_k=KW)
    windows, scan = [], JR._wideband_step_scan

    def spy(state, wr, wi, *args):
        windows.append(tuple(torch.from_numpy(np.array(w, np.float32))
                             for w in (wr, wi)))
        return scan(state, wr, wi, *args)
    path = str(tmp_path_factory.mktemp("jax") / "ckpt.npz")
    JR._wideband_step_scan = spy
    try:
        for i, chunk in enumerate(chunks(air[0], air[2])):
            if i == CUT:
                rx.save_state(path)
                before = len(windows)
            rx.process_wideband(chunk)
    finally:
        JR._wideband_step_scan = scan
    return rx, windows, path, before


@pytest.mark.parametrize("feed", ["cf32", "cs16"])
def test_host_feed_matches_staged(air, staged, feed):
    rx = _port()
    spy = Spy(rx)
    for chunk in chunks(air[0] if feed == "cf32" else air[1], air[2]):
        rx.process_wideband(chunk)
    srx, sspy = staged
    assert len(spy.packed) == M
    assert_same_windows(spy.windows, sspy.windows)
    assert_same_packed(spy.packed, sspy.packed)
    assert_same_decode(rx, srx)
    assert sum(rx.locked(c) for c in range(N)) == N
    # the superblocks took every sample but the last window's overlap
    wb = rx._wb
    assert wb["fill"] == wb["wide_len"] - wb["advance"]


def test_staged_feed_allocates_no_ring(staged):
    assert staged[0]._wb["ring"] is None


def test_one_window_superblocks_match_staged(air):
    """wb_k = 1: the tail left after a cut overlaps the window it leaves
    (the move goes through a temporary)."""
    cf32 = air[0]
    a, b = _port(1), _port(1)
    spy_a, spy_b = Spy(a), Spy(b)
    adv, wl = a._wb["advance"], a._wb["wide_len"]
    n = 4
    for chunk in chunks(cf32[:(n - 1) * adv + wl],
                        chunk_sizes(adv, 1, (n - 1) * adv + wl)):
        a.process_wideband(chunk)
    for wr, wi in staged_windows(cf32, adv, wl, 1, "cpu", count=n):
        b.process_wideband_staged(wr, wi)
    assert_same_windows(spy_a.windows, spy_b.windows)
    assert_same_packed(spy_a.packed, spy_b.packed)


def test_jax_cuts_the_same_windows(air, staged, jax_run):
    """The JAX package's windows equal the port's bit for bit; both end
    locked on every carrier, showing the same cells.  Their CRC tallies
    are not compared: on this air one carrier locks about a second
    earlier in the JAX package than in the port, staged or host-fed,
    before and after the ring (its float32 rounding, past the ingest)."""
    jrx, windows, _, _ = jax_run
    srx, sspy = staged
    assert_same_windows(windows, sspy.windows)
    for c in range(N):
        assert jrx.locked(c) and srx.locked(c), c
        assert jrx.display(c).as_dict() == srx.display(c).as_dict(), c


@pytest.mark.parametrize("first, then, match", [
    ("cs16", "cf32", "cannot mix"), ("cf32", "cs16", "cannot mix"),
    ("cs16", "odd", "whole I/Q pairs")])
def test_feeds_do_not_mix(air, first, then, match):
    rx = _port()
    rx.process_wideband(air[0][:1000] if first == "cf32" else air[1][:2000])
    bad = {"cf32": air[0][:10], "cs16": air[1][:20], "odd": air[1][:21]}
    with pytest.raises(ValueError, match=match):
        rx.process_wideband(bad[then])


@pytest.mark.parametrize("feed", ["cf32", "cs16"])
def test_checkpoint_resumes_bit_equal(air, tmp_path, feed):
    """Saved with samples pending in the ring: wb_buf holds them as the
    numpy buffer did (complex64, or interleaved int16), and a receiver
    restored from it resumes bit-equal to the one that ran on."""
    stream = air[0] if feed == "cf32" else air[1]
    parts = chunks(stream, air[2])
    a = _port()
    spy_a = Spy(a)
    for chunk in parts[:CUT]:
        a.process_wideband(chunk)
    path = os.path.join(tmp_path, "ckpt.npz")
    a.save_state(path)
    buf = np.load(path)["wb_buf"]
    fed = sum(air[2][:CUT])
    taken = len(spy_a.packed) * KW * a._wb["advance"]
    assert 0 < fed - taken < stream_len(a, 1)
    if feed == "cf32":
        assert buf.dtype == np.complex64
        np.testing.assert_array_equal(buf, stream[taken:fed])
    else:
        assert buf.dtype == np.int16
        np.testing.assert_array_equal(buf, stream[2 * taken:2 * fed])
    b = _port()
    b.load_state(path)
    spy_b = Spy(b)
    ran = len(spy_a.packed)
    for rx in (a, b):
        for chunk in parts[CUT:]:
            rx.process_wideband(chunk)
    assert_same_packed(spy_b.packed, spy_a.packed[ran:])
    assert_same_decode(b, a)
    assert b.fleet.state_bytes() == a.fleet.state_bytes()


def test_empty_checkpoint_keeps_the_buffer_dtype(air, tmp_path):
    """No pending sample: an empty complex64 buffer, or int16 once cs16
    was fed, as the numpy buffer was."""
    rx = _port()
    path = os.path.join(tmp_path, "empty.npz")
    rx.save_state(path)
    buf = np.load(path)["wb_buf"]
    assert buf.dtype == np.complex64 and len(buf) == 0
    rx.process_wideband(air[1][:0])
    rx.save_state(path)
    buf = np.load(path)["wb_buf"]
    assert buf.dtype == np.int16 and len(buf) == 0
    b = _port()
    b.load_state(path)
    assert b._wb["i16"] and b._wb["ring"] is None
    b.process_wideband(air[1][:20])
    with pytest.raises(ValueError, match="cannot mix"):
        b.process_wideband(air[0][:10])


def test_jax_checkpoint_loads_into_the_ring(air, jax_run):
    """The port restores the JAX package's checkpoint with its pending
    samples in the ring, then cuts the windows the JAX package cut."""
    _, windows, path, before = jax_run
    rx = _port()
    rx.load_state(path)
    np.testing.assert_array_equal(rx._ring_pending(),
                                  np.load(path)["wb_buf"])
    spy = Spy(rx)
    for chunk in chunks(air[0], air[2])[CUT:]:
        rx.process_wideband(chunk)
    assert_same_windows(spy.windows, windows[before:])
