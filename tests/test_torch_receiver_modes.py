"""The port's narrowband receiver in its other two demod modes, "ff" (the
feedforward block receiver) and "exact" (the per-sample parity chain), on
the CPU against tetra_tpu's on the same air: per-channel receivers of 1
and 4 channels, the fleet receiver with "ff", and checkpoints of both
modes restored across the packages in both directions.

The chains agree with the reference's to float32 rounding
(tests/test_torch_demod_exact.py, test_torch_demod_ff.py) and their
dibits are equal, so locks, displays and CRC tallies must be equal.
sym_quality (the last block's mean |phase error|) is held to 1e-3 for
"ff" only: on the heterogeneous 4-channel air (15-30 dB, +-100 ppm
clocks) the exact chain's timing and Costas loops take sign decisions on
near-zero errors, so their states walk apart from the reference's (mu by
up to 0.04 after 9 blocks, readings of seed 11) while every dibit stays
equal, and sym_quality read 1.5e-2 apart on one channel."""

import os

import numpy as np
import pytest
import torch

from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu_torch.rx import demod as TD
from tetra_tpu_torch.rx import demod_ff as TFF
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.tx import cell
from tetra_tpu_torch.tx.modulator import modulate
from tetra_tpu_torch.tx.wideband import heterogeneous_fleet_iq
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

MODES = ["ff", "exact"]


def one_cell(slots: int, seed: int = 0) -> np.ndarray:
    """One downlink (MCC 262, MNC 77, CC 9) at 22 dB SNR, 350 Hz CFO,
    modulated by the port, impaired with numpy noise: (1, T)."""
    bits, _ = cell.downlink_bits(cell.CellConfig(mcc=262, mnc=77, cc=9),
                                 slots, start=TdmaTime(mn=2, fn=14, tn=1))
    iq = modulate(bits[None], device="cpu").numpy()[0]
    rng = np.random.default_rng(seed)
    n = len(iq)
    iq = iq * np.exp(1j * (2 * np.pi * 350.0 / 36000 * np.arange(n) + 0.8))
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2)) * 10 ** (-22 / 20) / np.sqrt(2)
    iq = iq + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq[None, :n // 4096 * 4096].astype(np.complex64)


def _feed(rx, iq, block):
    for i in range(0, iq.shape[1] // block * block, block):
        rx.process(iq[:, i:i + block])
    return rx


def assert_same_decode(a, b, channels: int, quality: bool = True):
    for c in range(channels):
        assert a.locked(c) == b.locked(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
        assert a.crc_counts(c) == b.crc_counts(c), c
        assert a.quality_ok(c) == b.quality_ok(c), c
    if quality:
        np.testing.assert_allclose(a.sym_quality, b.sym_quality, atol=1e-3)


@pytest.fixture(scope="module")
def four():
    xr, xi = heterogeneous_fleet_iq(9, 4, 4608, seed=11)
    return np.concatenate(list(xr + 1j * xi), axis=1).astype(np.complex64)


@pytest.mark.parametrize("mode", MODES)
def test_one_channel_matches_jax(mode):
    iq = one_cell(110)
    got = _feed(TetraReceiver(1, mode=mode, events=False, device="cpu"),
                iq, 4096)
    ref = _feed(JaxReceiver(1, mode=mode, events=False), iq, 4096)
    assert isinstance(got.state, TD.DemodState if mode == "exact"
                      else TFF.FfDemodState)
    assert_same_decode(got, ref, 1)
    d = got.display(0)
    assert got.locked(0) and (d.mcc, d.mnc, d.cc) == (262, 77, 9)
    assert got.crc_counts(0)[0] > 30
    assert len(got.constellation(0)[0]) == len(ref.constellation(0)[0]) \
        == 256


@pytest.mark.parametrize("mode", MODES)
def test_four_channels_match_jax(mode, four):
    got = _feed(TetraReceiver(4, mode=mode, device="cpu"), four, 4608)
    ref = _feed(JaxReceiver(4, mode=mode), four, 4608)
    assert_same_decode(got, ref, 4, quality=mode == "ff")
    assert all(got.locked(c) for c in range(4))
    assert sum(got.crc_counts(c)[0] for c in range(4)) > 0


def test_fleet_ff_matches_jax(four):
    got = _feed(TetraReceiver(4, mode="ff", fleet=True, device="cpu"), four,
                4608)
    ref = _feed(JaxReceiver(4, mode="ff", fleet=True, events=False), four,
                4608)
    assert got.fleet is not None
    assert_same_decode(got, ref, 4)
    assert all(got.locked(c) for c in range(4))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_across_packages(mode, writer, tmp_path):
    """A checkpoint written mid-stream by one package restores in the
    other with the mode's own state type, and both continue exactly as
    the writer does."""
    iq = one_cell(110, seed=1)
    make = {"port": lambda: TetraReceiver(1, mode=mode, events=False,
                                          device="cpu"),
            "jax": lambda: JaxReceiver(1, mode=mode, events=False)}
    other = "jax" if writer == "port" else "port"
    cut = iq.shape[1] // 4096 // 2 * 4096
    a = _feed(make[writer](), iq[:, :cut], 4096)
    path = os.path.join(tmp_path, "ckpt.npz")
    a.save_state(path)
    z = np.load(path)
    for k in ("prev_sym", "mm_offset"):
        if f"demod_{k}" in z.files:
            assert z[f"demod_{k}"].dtype == np.int32, k
    b = make[other]()
    b.load_state(path)
    assert type(b.state) is type(a.state) if other == writer \
        else type(b.state).__name__ == type(a.state).__name__
    if other == "port":
        assert b.state.prev_sym.dtype == torch.int32
    for rx in (a, b):
        _feed(rx, iq[:, cut:], 4096)
    assert_same_decode(b, a, 1)
    assert b.locked(0) and b.display(0).mnc == 77
