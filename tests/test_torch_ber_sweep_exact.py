"""tests/test_ber_sweep.py's exact-chain operating point (20 dB, 900 Hz
CFO, the per-sample parity chain), the port against tetra_tpu on the same
IQ, held as tests/test_torch_ber_sweep.py holds the fast chain's points.
A file of its own: the two per-sample chains take ~70 s on one CPU."""

from tests.test_torch_ber_sweep import CFG, _run_both
from tests.test_torch_receiver_channel import (  # noqa: F401
    assert_same_decode, one_torch_thread)


def test_operating_region_exact_as_in_jax():
    got, ref = _run_both(20.0, 900.0, mode="exact")
    assert_same_decode(got, ref, 1)
    assert got.locked()
    d = got.display()
    assert (d.mcc, d.mnc, d.cc) == (CFG.mcc, CFG.mnc, CFG.cc)
    assert got.quality_ok()
    assert got.mac[0].crc_oks >= 60
