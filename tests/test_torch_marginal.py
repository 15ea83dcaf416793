"""The port against tetra_tpu where the signal drops out, the cell changes
and the SNR is marginal, on the CPU.

Bit level (tests/test_e2e.py:260 and :370 at their bit-level stage): the
same bits through each package's BurstSync and LowerMac, compared after
every feed: lock state and lock losses, TDMA time, CRC tallies, the cell
and its scrambling code, and the display.

IQ level (tests/test_fleet.py:98 and :125): the reference's streams
(tests/test_torch_fleet_parity.py builds them with tetra_tpu's TX from
its seeds) through the JAX receiver (its XLA twins on the CPU) and the
port's (its kernels' plain versions), fleet and per-channel.  Locks, lock
losses and the displayed cell must be equal, and the voice frames on the
handover stream.  The CRC tallies may differ by CRC_BOUND blocks a
channel: a last-bit difference can move a loop's convergence by a block,
and so the first SYNC burst caught, which carries 3 blocks.

Readings behind CRC_BOUND: the low-SNR stream at keys 0-4 and the
reference's 11, fleet and per-channel alike (the two paths are equal
within a package), |ok - ok'| + |fail - fail'| per channel:
key 0: 0 on seven channels, 3 on channel 6; key 1: 0 on seven, and
channel 2 (8.5 dB, -171 Hz) differs in lock; key 2: 0 everywhere; key 3:
0 everywhere; key 4: 3 on channel 1; key 11: 3 on channel 0.
On key 1 channel 2 the two chains' FLLs sit within 2e-6 rad/sample of
each other and of the CFO, but the timing and Costas loops converge from
the cold start in block 9 in the port (sym_quality 0.208) and in block
10 in JAX (0.427, then 0.160): the port catches block 9's SYNC burst and
locks (166 ok, 2 failed), JAX does not (0 ok, 18 failed), and the next
SYNC burst lies past the 130-slot stream.  This is the acquisition-basin
difference of ROADMAP Queue 3 ("comparison rules"); the test runs the
reference's key 11 and holds locks equal there."""

import numpy as np
import pytest

from tetra_tpu import params as JP
from tetra_tpu.rx.burst_sync import BurstSync as JaxBurstSync
from tetra_tpu.rx.lower_mac import LowerMac as JaxLowerMac
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import PhyState as JaxPhyState
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu_torch.rx.burst_sync import RX_LOCKED, BurstSync
from tetra_tpu_torch.rx.lower_mac import LowerMac
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.rx.tdma import PhyState
from tests.test_torch_fleet_parity import (CELL_B, handover_iq,
                                           low_snr_iq)
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

CRC_BOUND = 3
CFG = cell.CellConfig()
START = TdmaTime(mn=1, fn=17, tn=4)


# -- bit level ---------------------------------------------------------------


def _observe(sync, mac):
    t = sync.phy.time
    d = mac.upper.display
    return (sync.state, sync.lock_losses, (t.hn, t.mn, t.fn, t.tn),
            mac.crc_oks, mac.crc_fails, mac.cell.scramb_init,
            (d.mcc, d.mnc, d.cc, d.curr_multiframe))


def _bit_run(bits: np.ndarray):
    """bits through both packages' BurstSync + LowerMac in 4-slot feeds
    (the reference's chunking); the observables after every feed."""
    runs = []
    for sync_cls, mac_cls, phy_cls, kw in (
            (BurstSync, LowerMac, PhyState, dict(device="cpu")),
            (JaxBurstSync, JaxLowerMac, JaxPhyState, {})):
        phy = phy_cls()
        sync, mac = sync_cls(phy=phy), mac_cls(phy=phy, **kw)
        seen = []
        for i in range(0, len(bits), 510 * 4):
            mac.process_bursts(sync.feed(bits[i:i + 510 * 4]))
            seen.append(_observe(sync, mac))
        runs.append((seen, sync, mac))
    (got, sync, mac), (want, _, _) = runs
    assert got == want
    return sync, mac


def test_dropout_and_relock_bit_level_matches_jax():
    """test_e2e.py:260 at the bit level: the cell, 1 s of dead air (what
    the demod makes of noise: seeded random bits), the cell again one
    multiframe on.  Lock is lost in the gap and regained."""
    bits1, _ = cell.downlink_bits(CFG, 170, start=START.copy())
    bits2, _ = cell.downlink_bits(CFG, 170, start=TdmaTime(mn=9, fn=17,
                                                            tn=4))
    gap = np.random.default_rng(8).integers(0, 2, 36000).astype(np.uint8)
    sync, mac = _bit_run(np.concatenate([bits1, gap, bits2]))
    assert sync.state == RX_LOCKED and sync.lock_losses >= 1
    d = mac.upper.display
    assert (d.mcc, d.mnc, d.cc) == (CFG.mcc, CFG.mnc, CFG.cc)
    assert d.curr_multiframe >= 9


def test_cell_handover_scrambling_change_bit_level_matches_jax():
    """test_e2e.py:370: the serving cell changes mid-stream on the same
    slot grid; lock survives, the new SYNC PDU is adopted with its
    scrambling code, and the new cell's blocks decode."""
    cfg_b = cell.CellConfig(mcc=505, mnc=88, cc=33)
    bits_a, _ = cell.downlink_bits(CFG, 170, start=START.copy())
    bits_b, _ = cell.downlink_bits(cfg_b, 170,
                                   start=TdmaTime(mn=4, fn=5, tn=1))
    sync, mac = _bit_run(np.concatenate([bits_a, bits_b]))
    assert sync.state == RX_LOCKED and sync.lock_losses == 0
    d = mac.upper.display
    assert (d.mcc, d.mnc, d.cc) == (cfg_b.mcc, cfg_b.mnc, cfg_b.cc)
    assert mac.cell.scramb_init == JP.scramb_get_init(cfg_b.mcc, cfg_b.mnc,
                                                      cfg_b.cc)
    assert mac.crc_oks >= 300


# -- IQ level ----------------------------------------------------------------


def _receivers(mode: str, C: int, voice: bool):
    """The port's and the reference's receiver of one mode, each with a
    voice sink when asked."""
    out = {"port": [], "jax": []}
    sink = lambda k: ((lambda t, b: out[k].append((str(t), b.tobytes())))
                      if voice else None)
    kw = dict(fleet=True) if mode == "fleet" else dict(events=False,
                                                       device_acquire=False)
    return (TetraReceiver(C, voice_cb=sink("port"), device="cpu", **kw),
            JaxReceiver(C, voice_cb=sink("jax"), **kw), out)


def _lock_losses(rx, c: int) -> int:
    return rx.fleet.lock_losses(c) if rx.fleet is not None \
        else rx.sync[c].lock_losses


def _run_both(iq: np.ndarray, mode: str, voice: bool = False):
    got, ref, frames = _receivers(mode, iq.shape[0], voice)
    for i in range(iq.shape[1] // 4096):
        blk = iq[:, i * 4096:(i + 1) * 4096]
        got.process(blk)
        ref.process(blk)
    for c in range(iq.shape[0]):
        assert got.locked(c) == ref.locked(c), c
        assert _lock_losses(got, c) == _lock_losses(ref, c), c
        assert got.display(c).as_dict() == ref.display(c).as_dict(), c
        (oa, fa), (ob, fb) = got.crc_counts(c), ref.crc_counts(c)
        assert abs(oa - ob) + abs(fa - fb) <= CRC_BOUND, (c, (oa, fa),
                                                          (ob, fb))
    return got, frames


@pytest.mark.parametrize("mode", ["fleet", "channel"])
def test_low_snr_fuzz_matches_jax(mode):
    """test_fleet.py:125's 8 channels at 7.5-11 dB, CFOs over +-400 Hz."""
    got, _ = _run_both(low_snr_iq(), mode)
    assert sum(got.locked(c) for c in range(8)) >= 6
    assert sum(got.crc_counts(c)[1] for c in range(8)) > 0


@pytest.mark.parametrize("mode", ["fleet", "channel"])
def test_dropout_handover_voice_matches_jax(mode):
    """test_fleet.py:98's stream (voice, a stolen slot, 0.5 s of dead air,
    then another cell): the same locks, lock losses, display and voice
    frames in both packages, ending on the new cell."""
    got, frames = _run_both(handover_iq(), mode, voice=True)
    assert frames["port"] == frames["jax"] and len(frames["port"]) > 10
    assert _lock_losses(got, 0) >= 1 and got.locked(0)
    d = got.display(0)
    assert (d.mcc, d.mnc, d.cc) == (CELL_B.mcc, CELL_B.mnc, CELL_B.cc)
