"""The port's per-channel (non-fleet) receiver on the CPU against
tetra_tpu's: wideband (8 channels of 2 cells, cf32 and cs16 feeds, with
the device SYNC acquisition off and on) and narrowband (4 channels, with
the coarse-CFO preset).

The reference runs its XLA twins on the CPU while the port runs its
kernels' plain versions, which round differently, so over seconds of air
the loop states drift apart in the last bits.  Lock, display and the cells
shown must be identical, the CRC tallies within CRC_BOUND blocks per
channel, and sym_quality within 2e-3.  The constellation is compared from
a shared state (tests/test_torch_receiver_ckpt.py)."""

import numpy as np
import pytest
import torch

from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import (heterogeneous_fleet_iq,
                                         synthesize_wideband)

N = 8
T50 = 1600
CRC_BOUND = 2
QUALITY_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one CPU thread.  The receivers issue
    many small ops; torch's idle worker threads spin between them, which
    triples the CPU time of these tests for no gain in wall time and slows
    the other test processes that share the cores.  Results do not depend
    on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_pair_air(n_ch: int = N, slots: int = 120) -> np.ndarray:
    """n_ch carriers alternating two cells (MNC 100 and 101), 25 dB SNR,
    120 Hz CFO (the fleet tests' fixture)."""
    streams = []
    for i in range(2):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=100 + i, cc=1 + i), slots,
            start=TdmaTime(mn=2, fn=14, tn=1))
        streams.append(bits)
    L = min(len(s) for s in streams)
    bitmat = np.stack([streams[c % 2][:L] for c in range(n_ch)])
    return synthesize_wideband(bitmat, n_ch, cfo_hz=120.0, snr_db=25.0,
                               seed=3)


def feed(rx, data, chunk: int = 120000):
    """Feed data in chunks (cs16 chunks are whole I/Q pairs)."""
    for i in range(0, len(data), chunk):
        rx.process_wideband(data[i:i + chunk])
    return rx


def assert_same_decode(a, b, channels: int, bound: int = CRC_BOUND):
    for c in range(channels):
        assert a.locked(c) == b.locked(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
        (oa, fa), (ob, fb) = a.crc_counts(c), b.crc_counts(c)
        assert abs(oa - ob) + abs(fa - fb) <= bound, (c, (oa, fa), (ob, fb))
        assert a.quality_ok(c) == b.quality_ok(c), c
    np.testing.assert_allclose(a.sym_quality, b.sym_quality,
                               atol=QUALITY_TOL)


@pytest.fixture(scope="module")
def feeds():
    """The fixture as complex64, as interleaved cs16 at full scale, and
    as the complex64 samples that cs16 feed stands for."""
    wide = cell_pair_air()
    q = np.round(wide * (32767 / np.abs(wide).max()))
    cs16 = np.stack([q.real, q.imag], axis=1).reshape(-1).astype(np.int16)
    return {"cf32": wide, "cs16": cs16,
            "cf32_of_cs16": (q / 32768.0).astype(np.complex64)}


@pytest.fixture(scope="module")
def runs(feeds):
    """run(package, feed, device_acquire): a receiver fed the whole feed,
    made once per key."""
    cache = {}

    def run(pkg, fmt, da):
        if (pkg, fmt, da) not in cache:
            rx = (JaxReceiver(wideband=N, t50=T50, device_acquire=da)
                  if pkg == "jax" else
                  TetraReceiver(wideband=N, t50=T50, device_acquire=da,
                                device="cpu"))
            cache[pkg, fmt, da] = feed(rx, feeds[fmt])
        return cache[pkg, fmt, da]

    return run


@pytest.mark.parametrize("fmt", ["cf32", "cs16"])
@pytest.mark.parametrize("device_acquire", [False, True])
def test_wideband_channel_matches_jax(runs, fmt, device_acquire):
    got = runs("port", fmt, device_acquire)
    ref = runs("jax", fmt, device_acquire)
    assert got.fleet is None and got.device_acquire is device_acquire
    assert_same_decode(got, ref, N)
    for c in range(N):
        assert got.locked(c), c
        assert got.display(c).mnc == 100 + c % 2, c
        assert got.crc_counts(c)[0] > 60, c
        assert got.quality_ok(c), c
        assert got.sync[c].state == ref.sync[c].state, c
        assert got.mac[c].cell.scramb_init == ref.mac[c].cell.scramb_init
        assert len(got.constellation(c)[0]) == 256, c
    assert (got.acquire_scans > 0) == device_acquire


def test_wideband_cs16_equals_cf32_bit_for_bit(runs):
    """cs16 converts on the device to the very floats of the cf32 feed of
    the same samples: the two decodes are identical."""
    a = runs("port", "cs16", False)
    b = runs("port", "cf32_of_cs16", False)
    assert_same_decode(a, b, N, bound=0)
    np.testing.assert_array_equal(a.sym_quality, b.sym_quality)


def test_narrowband_channel_matches_jax():
    """process() of (C, T) blocks at 36 ksps: the first block presets each
    channel's FLL from the coarse CFO estimate, then the chain runs.
    sym_quality is compared after every block past the first two, where
    cold acquisition may take the two packages' loops different ways."""
    xr, xi = heterogeneous_fleet_iq(9, 4, 4608, seed=5)
    iq = (xr + 1j * xi).astype(np.complex64)
    ref = JaxReceiver(channels=4)
    got = TetraReceiver(channels=4, device="cpu")
    np.testing.assert_array_equal(TetraReceiver.coarse_cfo(iq[0]),
                                  JaxReceiver.coarse_cfo(iq[0]))
    for b in range(iq.shape[0]):
        ref.process(iq[b])
        got.process(iq[b])
        if b >= 2:
            np.testing.assert_allclose(got.sym_quality, ref.sym_quality,
                                       atol=QUALITY_TOL)
    assert_same_decode(got, ref, 4)
    assert sum(got.crc_counts(c)[0] for c in range(4)) > 0
    for c in range(4):
        assert got.locked(c), c
        a, b = got.constellation(c), ref.constellation(c)
        assert len(a[0]) == len(b[0]) == 256, c
