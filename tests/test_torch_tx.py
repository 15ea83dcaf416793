"""The port's TX side (tx/modulator.py, tx/channel.py,
tx/wideband.assemble_wideband, tx/modulator2.py) on the CPU against
tetra_tpu's, on the same seeded numpy inputs.

Tolerances, from readings over seeds 0-4: the port's symbols and
waveforms are within 2e-6 of a float64 numpy model of the same
modulator; the reference's sum its cumulative phase in float32 radians
and drift from that model by up to 1e-5 over 256 symbols and 6e-5 over
4096 (the port counts pi/4 steps exactly), so the port is held to the
reference at 1e-5 on 512-bit streams and at the reference's own drift
plus 1e-5 on longer ones.  apply_cfo, the noiseless channel and
assemble_wideband agree with the reference within 1e-5 (readings
<= 6e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu.core import taps as JT
from tetra_tpu.tx import channel as JCHAN
from tetra_tpu.tx import modulator as JM
from tetra_tpu.tx import wideband as JWB
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.tx import cell, modulator2
from tetra_tpu_torch.tx import channel as TCHAN
from tetra_tpu_torch.tx import modulator as TM
from tetra_tpu_torch.tx.wideband import assemble_wideband
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

TOL = 1e-5
TOL_MODEL = 2e-6


def _model(bits: np.ndarray, sps: int = 2) -> np.ndarray:
    """float64 numpy model of the modulator: exact cumulative phase, the
    same float32 RRC taps, the same causal valid-mode FIR."""
    dib = (bits[..., 0::2].astype(np.int64) << 1) | bits[..., 1::2]
    phase = np.pi / 4 * np.cumsum(np.array([1, 3, -1, -3])[dib], axis=-1)
    syms = np.exp(1j * phase)
    up = np.zeros(syms.shape[:-1] + (syms.shape[-1] * sps,), complex)
    up[..., ::sps] = syms
    h = np.asarray(JT.root_raised_cosine(65, 0.35, 1.0, float(sps)),
                   np.float32) * sps
    return np.stack([np.convolve(u, h)[:u.shape[0]] for u in up])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_modulate_matches_model_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n_bits in (512, 8192):
        bits = rng.integers(0, 2, (2, n_bits)).astype(np.uint8)
        got = TM.modulate(bits, device="cpu").numpy()
        ref = np.asarray(JM.modulate(jnp.asarray(bits)))
        model = _model(bits)
        assert got.dtype == ref.dtype == np.complex64
        assert got.shape == ref.shape == (2, n_bits)
        np.testing.assert_allclose(got, model, atol=TOL_MODEL)
        drift = np.abs(ref - model).max()
        assert np.abs(got - ref).max() <= (TOL if n_bits == 512
                                           else drift + TOL), n_bits
    sym = TM.bits_to_symbols(bits[0], device="cpu").numpy()
    np.testing.assert_allclose(
        sym, np.exp(1j * np.angle(JM.bits_to_symbols(bits[0]))), atol=1e-3)


def test_modulate_sps4_and_phase0():
    bits = np.random.default_rng(3).integers(0, 2, (1, 600)).astype(np.uint8)
    got = TM.modulate(bits, sps=4, phase0=0.7, device="cpu").numpy()
    ref = np.asarray(JM.modulate(jnp.asarray(bits), sps=4, phase0=0.7))
    np.testing.assert_allclose(got, ref, atol=TOL)


def _iq(seed, shape=(2, 5000)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("cfo", [-850.0, 0.0, 312.5])
def test_apply_cfo_matches_jax(cfo):
    iq = _iq(4)
    ref = np.asarray(JCHAN.apply_cfo(jnp.asarray(iq), cfo, 36000.0, 0.4))
    got = TCHAN.apply_cfo(iq, cfo, 36000.0, 0.4, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_channel_without_noise_matches_jax():
    """snr 200 dB: the noise is 1e-10 of the signal, so the delay, gain,
    phase and CFO stages must agree with the reference's."""
    iq = _iq(5)
    kw = dict(snr_db=200.0, cfo_hz=-420.0, sample_rate=36000.0, gain=1.7,
              phase0=-2.1, delay_samples=33)
    ref = np.asarray(JCHAN.channel(jnp.asarray(iq), jax.random.key(1), **kw))
    got = TCHAN.channel(iq, torch.Generator().manual_seed(1), device="cpu",
                        **kw).numpy()
    assert got.shape == ref.shape == (2, 5033)
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_add_awgn_power_and_reproducible():
    iq = np.ones((2, 200_000), np.complex64)
    gen = lambda: torch.Generator().manual_seed(7)
    a = TCHAN.add_awgn(iq, 10.0, gen(), device="cpu")
    b = TCHAN.add_awgn(torch.from_numpy(iq), 10.0, gen())
    assert torch.equal(a, b)
    noise_p = float(((a - 1).abs() ** 2).mean())
    assert abs(noise_p / 0.1 - 1) < 0.05, noise_p
    c = TCHAN.add_awgn(iq, 10.0, torch.Generator().manual_seed(8),
                       device="cpu")
    assert not torch.equal(a, c)
    half = TCHAN.add_awgn(iq, 10.0, gen(), signal_power=0.5, device="cpu")
    assert abs(float(((half - 1).abs() ** 2).mean()) / 0.05 - 1) < 0.05


def test_assemble_wideband_matches_jax():
    rng = np.random.default_rng(6)
    chans = {k: (rng.standard_normal(3600)
                 + 1j * rng.standard_normal(3600)).astype(np.complex64)
             for k in (0, 3, 7)}
    ref = JWB.assemble_wideband(chans, 8, amplitude=0.5)
    got = assemble_wideband(chans, 8, amplitude=0.5, device="cpu")
    assert got.dtype == ref.dtype == np.complex64
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_port_receiver_decodes_cleanroom_modulator():
    """tests/test_modulator2.py's decode on the port: a downlink shaped by
    the clean-room modulator (the port's byte-equal copy) at 20 dB SNR +
    300 Hz CFO locks the port's receiver, decodes the cell, and runs
    CRC-clean once a CRC passed."""
    rng = np.random.default_rng(4)
    bits, _ = cell.downlink_bits(cell.CellConfig(mcc=262, mnc=31, cc=4),
                                 170, start=TdmaTime(mn=2, fn=14, tn=1))
    iq = modulator2.modulate(bits)
    n = len(iq)
    iq = iq * np.exp(1j * (2 * np.pi * 300.0 / 36000.0 * np.arange(n)
                           + 1.23))
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2)) * 10 ** (-20 / 20) / np.sqrt(2)
    iq = iq + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = iq[:(len(iq) // 512) * 512].astype(np.complex64)
    rx = TetraReceiver(1, device="cpu")
    fails_after_first_ok, first_ok_seen, prev = 0, False, (0, 0)
    for i in range(0, len(iq), 512 * 16):
        rx.process(iq[None, i:i + 512 * 16])
        cur = rx.crc_counts(0)
        if first_ok_seen:
            fails_after_first_ok += cur[1] - prev[1]
        first_ok_seen |= cur[0] > 0
        prev = cur
    d = rx.display(0)
    assert rx.locked(0) and (d.mcc, d.mnc, d.cc) == (262, 31, 4)
    assert rx.crc_counts(0)[0] > 200
    assert fails_after_first_ok <= 2
    assert float(rx.sym_quality[0]) < 0.15


def test_tx_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    bits = np.zeros((1, 8), np.uint8)
    for call in (lambda: TM.modulate(bits), lambda: TM.bits_to_symbols(bits),
                 lambda: TCHAN.apply_cfo(bits.astype(np.complex64), 1.0, 1.0),
                 lambda: assemble_wideband({0: np.zeros(360, np.complex64)},
                                           8)):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            call()
