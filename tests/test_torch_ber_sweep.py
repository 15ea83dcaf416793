"""tests/test_ber_sweep.py's operating region, the port against tetra_tpu on
the same IQ (tetra_tpu's TX and tx.channel, keyed by the SNR as there):
at 30/25/20 dB with the fast chain (and at 20 dB with the exact chain,
tests/test_torch_ber_sweep_exact.py, a file of its own for its ~70 s)
both receivers lock, show the cell, pass quality_ok and decode >= 60 blocks
after acquisition, with locks, display and quality equal and the CRC
tallies within the receiver tests' CRC_BOUND of 2 blocks.  At 8 dB
neither shows a cell other than the true one (the CRC gates false
decodes from the MAC; the display shows every SYNC PDU's fields)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tetra_tpu import params as P
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu.tx.channel import channel
from tetra_tpu.tx.modulator import modulate
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tests.test_torch_receiver_channel import (  # noqa: F401
    assert_same_decode, one_torch_thread)

CFG = cell.CellConfig()
START = TdmaTime(mn=1, fn=17, tn=4)


def _run_both(snr_db: float, cfo_hz: float, n_slots: int = 240,
              mode: str = "fast"):
    """test_ber_sweep.py:24 `_run`, through both packages."""
    bits, _ = cell.downlink_bits(CFG, n_slots, start=START.copy())
    iq = modulate(jnp.asarray(bits[None, :]))
    iq = np.asarray(channel(iq, jax.random.key(int(snr_db * 10)),
                            snr_db=snr_db, cfo_hz=cfo_hz,
                            sample_rate=P.SAMPLE_RATE))
    got = TetraReceiver(1, mode=mode, device="cpu")
    ref = JaxReceiver(1, mode=mode)
    for i in range(iq.shape[1] // 4096):
        got.process(iq[:, i * 4096:(i + 1) * 4096])
        ref.process(iq[:, i * 4096:(i + 1) * 4096])
    return got, ref


@pytest.mark.parametrize("snr_db,cfo_hz,mode", [
    (30.0, 0.0, "fast"),
    (25.0, -400.0, "fast"),
    (20.0, 900.0, "fast"),
])
def test_operating_region_clean_as_in_jax(snr_db, cfo_hz, mode):
    got, ref = _run_both(snr_db, cfo_hz, mode=mode)
    assert_same_decode(got, ref, 1)
    assert got.locked()
    d = got.display()
    assert (d.mcc, d.mnc, d.cc) == (CFG.mcc, CFG.mnc, CFG.cc)
    assert got.quality_ok()
    assert got.mac[0].crc_oks >= 60


def test_low_snr_shows_no_false_cell_as_in_jax():
    """8 dB, 100 slots: whatever either package shows is the true cell,
    and both show the same."""
    got, ref = _run_both(8.0, 0.0, n_slots=100)
    for rx in (got, ref):
        d = rx.display()
        if d.mcc != 0:
            assert (d.mcc, d.mnc) == (CFG.mcc, CFG.mnc)
        ok, fails = rx.crc_counts()
        assert ok + fails == 0 or ok <= ok + fails
    assert got.display().as_dict() == ref.display().as_dict()
    assert got.locked() == ref.locked()
