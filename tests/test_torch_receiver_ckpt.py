"""Per-channel (non-fleet) receiver checkpoints across the two packages,
and the constellation compared from a shared state.

A checkpoint carries the reference's non-fleet npz keys (demod_*, sync{c},
bitbuf{c}, cell{c}, sym_quality, wb_*).  Written mid-stream by either
package, it restores in both: the writer's own package then continues
exactly as the writer does, the other within the decode-level bound of
tests/test_torch_receiver_channel.py.

From a state both packages share (the JAX receiver's checkpoint after 46
cycles, 1.47 s of air, past the first lock, loaded into the port), two
more cycles run through the
JAX Pallas kernels in interpret mode and through the port's plain
versions: the constellation of every locked channel agrees at the 2e-4
that tests/test_torch_demod.py holds sym_re to over two chained blocks."""

import os

import numpy as np
import pytest
import torch

from tetra_tpu.rx import demod_fast as JDF
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tests.test_torch_receiver_channel import (  # noqa: F401
    N, QUALITY_TOL, T50, assert_same_decode, cell_pair_air, feed,
    one_torch_thread)

SYM_TOL = 2e-4


@pytest.fixture(scope="module")
def wide():
    return cell_pair_air()


def make_port():
    return TetraReceiver(wideband=N, t50=T50, device="cpu")


def make_jax():
    return JaxReceiver(wideband=N, t50=T50)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_channel_checkpoint_restores_across_packages(wide, tmp_path, writer):
    first, other = (make_port, make_jax) if writer == "port" \
        else (make_jax, make_port)
    a = first()
    cut = 6 * a._wb["advance"] + 12345        # mid-window, mid-buffer
    feed(a, wide[:cut])
    path = os.path.join(tmp_path, "ckpt.npz")
    a.save_state(path)
    keys = set(np.load(path).files)
    assert {f"{k}{c}" for k in ("sync", "bitbuf", "cell")
            for c in range(N)} <= keys
    assert {"sym_quality", "wb_buf", "wb_hist_r", "wb_hist_i",
            "demod_fll_freq"} <= keys and "fleet_blob" not in keys
    same, cross = first(), other()
    same.load_state(path)
    cross.load_state(path)
    for rx in (a, same, cross):
        feed(rx, wide[cut:])
    for c in range(N):
        assert same.crc_counts(c) == a.crc_counts(c), c
        assert same.display(c).as_dict() == a.display(c).as_dict(), c
        assert same.sync[c].lock_losses == a.sync[c].lock_losses, c
    np.testing.assert_array_equal(same.sym_quality, a.sym_quality)
    assert_same_decode(cross, a, N)
    assert all(cross.locked(c) for c in range(N))


def test_cs16_channel_checkpoint_resumes_as_uninterrupted(wide, tmp_path):
    """A per-channel receiver fed cs16 and checkpointed with samples in its
    wideband buffer resumes in the port to the same locks, lock losses,
    CRC tallies, display, sym_quality and demod state as the receiver
    that ran on.  The reference casts the buffer to complex64 on restore,
    so its next cs16 feed raises (the port's deliberate difference,
    load_state's docstring)."""
    q = np.round(wide * (32767 / np.abs(wide).max()))
    cs16 = np.stack([q.real, q.imag], axis=1).reshape(-1).astype(np.int16)
    a = make_port()
    cut = 2 * (6 * a._wb["advance"] + 12345)      # whole I/Q pairs
    feed(a, cs16[:cut])
    assert a._wb["buf"].dtype == np.int16 and len(a._wb["buf"]) > 0
    path = os.path.join(tmp_path, "cs16.npz")
    a.save_state(path)
    b = make_port()
    b.load_state(path)
    assert b._wb["buf"].dtype == np.int16
    np.testing.assert_array_equal(b._wb["buf"], a._wb["buf"])
    for rx in (a, b):
        feed(rx, cs16[cut:])
    for c in range(N):
        assert b.locked(c) == a.locked(c) and a.locked(c), c
        assert b.sync[c].lock_losses == a.sync[c].lock_losses, c
        assert b.crc_counts(c) == a.crc_counts(c), c
        assert b.display(c).as_dict() == a.display(c).as_dict(), c
    np.testing.assert_array_equal(b.sym_quality, a.sym_quality)
    for k, v in a.state._asdict().items():
        assert torch.equal(getattr(b.state, k), v), k
    j = make_jax()
    j.load_state(path)
    assert j._wb["buf"].dtype == np.complex64
    with pytest.raises(AssertionError, match="cannot mix cs16 and cf32"):
        j.process_wideband(cs16[cut:cut + 4096])


def test_fleet_and_channel_checkpoints_do_not_mix(wide, tmp_path):
    a = make_port()
    feed(a, wide[:3 * a._wb["advance"]])
    path = os.path.join(tmp_path, "channel.npz")
    a.save_state(path)
    fleet = TetraReceiver(wideband=N, t50=T50, fleet=True, device="cpu")
    with pytest.raises(ValueError, match="fleet mode"):
        fleet.load_state(path)


def test_constellation_matches_jax_from_shared_state(wide, tmp_path):
    j = make_jax()
    adv = j._wb["advance"]
    cut = (j._wb["wide_len"] - adv) + 46 * adv   # 46 whole cycles
    feed(j, wide[:cut])
    path = os.path.join(tmp_path, "warm.npz")
    j.save_state(path)
    t = make_port()
    t.load_state(path)
    nxt = wide[cut:cut + 2 * adv]
    with JDF.pallas_interpret():
        j.process_wideband(nxt)
    t.process_wideband(nxt)
    locked = [c for c in range(N) if j.locked(c)]
    assert len(locked) == N
    for c in locked:
        (tr, ti), (jr, ji) = t.constellation(c), j.constellation(c)
        assert len(tr) == len(jr) == 256, c
        np.testing.assert_allclose(tr, np.asarray(jr), atol=SYM_TOL)
        np.testing.assert_allclose(ti, np.asarray(ji), atol=SYM_TOL)
        assert t.crc_counts(c) == j.crc_counts(c), c
        assert t.quality_ok(c) and j.quality_ok(c), c
    np.testing.assert_allclose(t.sym_quality, j.sym_quality, atol=QUALITY_TOL)
    tr, _ = t.constellation(0, n=17)
    assert len(tr) == 17 and tr.dtype == np.float32
