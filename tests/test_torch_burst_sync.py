"""The port's burst synchronizer (rx/burst_sync) and training-sequence
correlation (ops/train_corr) against tetra_tpu's on the same seeded bits:
the bursts, the lock state after every feed, the hit masks and the staged
device-acquisition results must all be equal.  The port correlates on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu import params as JP
from tetra_tpu.ops import train_corr as JTC
from tetra_tpu.rx import burst_sync as JBS
from tetra_tpu.rx.tdma import TdmaTime as JTdmaTime
from tetra_tpu.tx import cell as JCELL
from tetra_tpu_torch.ops import train_corr as TTC
from tetra_tpu_torch.rx import burst_sync as TBS
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

START = JTdmaTime(mn=1, fn=17, tn=4)


@pytest.fixture(scope="module")
def stream():
    """A noise prefix, a cell, dropout garbage, the cell again (the
    reference's tests/test_e2e.py acquisition stream)."""
    rng = np.random.default_rng(11)
    bits, _ = JCELL.downlink_bits(JCELL.CellConfig(), 60, start=START.copy())
    bits2, _ = JCELL.downlink_bits(JCELL.CellConfig(), 40, start=START.copy())
    return np.concatenate([
        rng.integers(0, 2, 2977).astype(np.uint8), bits,
        rng.integers(0, 2, 4000).astype(np.uint8), bits2])


def _sync_state(s):
    return (s.state, s.bitbuf_start_bitnum, s.next_frame_start_bitnum,
            s.lock_losses, s.scan_from, s.pending_scan, s.bitbuf.tobytes(),
            vars(s.phy.time), s.phy.slot_count)


def _bursts(bl):
    return [(b.train_seq, b.bits.tobytes(), vars(b.time), b.slot_index,
             [(t, n, np.asarray(x).tobytes()) for t, n, x in b.blocks()])
            for b in bl]


@pytest.mark.parametrize("chunk", [2048, 777, 9000])
def test_burst_sync_matches_jax(stream, chunk):
    js, ts = JBS.BurstSync(), TBS.BurstSync()
    n = 0
    for i in range(0, len(stream), chunk):
        part = stream[i:i + chunk]
        jb, tb = js.feed(part.copy()), ts.feed(part.copy())
        assert _bursts(tb) == _bursts(jb), i
        assert _sync_state(ts) == _sync_state(js), i
        n += len(tb)
    assert n > 50 and ts.lock_losses >= 1 and ts.state == TBS.RX_LOCKED


def test_find_train_seq_matches_jax():
    rng = np.random.default_rng(3)
    seqs = (JP.TRAIN_SEQ_SYNC, JP.TRAIN_SEQ_NORM_1, JP.TRAIN_SEQ_NORM_2)
    for k in range(40):
        bits = rng.integers(0, 2, 600).astype(np.uint8)
        sid = seqs[k % 3]
        if k % 4:
            o = int(rng.integers(0, 560))
            bits[o:o + len(JP.TRAIN_SEQS[sid])] = JP.TRAIN_SEQS[sid]
        which = seqs if k % 2 else (sid,)
        assert TBS.find_train_seq(bits, which) == \
            JBS.find_train_seq(bits, which), k


def _planted(C, L, seed):
    """(C, L) random bits with training sequences planted at known
    offsets, one near each row's end."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (C, L)).astype(np.uint8)
    for c in range(C):
        for sid in (JP.TRAIN_SEQ_SYNC, JP.TRAIN_SEQ_NORM_1,
                    JP.TRAIN_SEQ_NORM_2):
            seq = JP.TRAIN_SEQS[sid]
            for o in (int(rng.integers(0, L - 60)), L - len(seq)):
                bits[c, o:o + len(seq)] = seq
    return bits


def test_train_seq_hits_matches_jax():
    bits = _planted(5, 3000, 7)
    want = JTC.train_seq_hits(jnp.asarray(bits))
    got = TTC.train_seq_hits(torch.from_numpy(bits))
    assert sorted(got) == sorted(want)
    for sid in want:
        assert got[sid].dtype == torch.bool
        np.testing.assert_array_equal(got[sid].numpy(), np.asarray(want[sid]))
        assert got[sid].numpy().sum() >= len(bits)
    fj, ft = JTC.first_hits(bits), TTC.first_hits(bits, device="cpu")
    assert sorted(ft) == sorted(fj)
    for sid in fj:
        np.testing.assert_array_equal(ft[sid], fj[sid])


def test_device_acquire_scan_matches_jax(stream):
    """Staged scans and the bursts they lead to equal the JAX package's
    device path and its host path (the reference's own e2e test)."""
    host, jdev, tdev = JBS.BurstSync(), JBS.BurstSync(), TBS.BurstSync()
    scans = 0
    for i in range(0, len(stream), 2048):
        chunk = stream[i:i + 2048]
        bh = host.feed(chunk.copy())
        assert jdev.state == tdev.state
        if tdev.state == TBS.RX_UNLOCKED:
            JBS.device_acquire_scan([jdev], [chunk], pad_channels=4)
            TBS.device_acquire_scan([tdev], [chunk], pad_channels=4,
                                    device="cpu")
            assert tdev.pending_scan == jdev.pending_scan, i
            scans += 1
        bj, bt = jdev.feed(chunk.copy()), tdev.feed(chunk.copy())
        assert _bursts(bt) == _bursts(bj) == _bursts(bh), i
        assert _sync_state(tdev) == _sync_state(jdev), i
    assert scans > 3 and tdev.lock_losses >= 1


def test_device_acquire_scan_many_channels():
    """One call over channels of different lengths and scan positions
    (rows padded with 01 and masked at each row's end), against the JAX
    package: equal pending_scan on every channel."""
    rng = np.random.default_rng(5)
    bits = _planted(6, 5000, 9)
    jsy, tsy, feeds = [], [], []
    for c in range(6):
        pre = rng.integers(0, 2, 300 * c).astype(np.uint8)
        j, t = JBS.BurstSync(), TBS.BurstSync()
        for s in (j, t):
            s.feed(pre.copy())
        jsy.append(j)
        tsy.append(t)
        feeds.append(bits[c, :1000 + 700 * c])
    JBS.device_acquire_scan(jsy, feeds, pad_channels=8)
    TBS.device_acquire_scan(tsy, feeds, pad_channels=8, device="cpu")
    assert [s.pending_scan for s in tsy] == [s.pending_scan for s in jsy]
    assert sum(s.pending_scan[0] >= 0 for s in tsy) >= 5
