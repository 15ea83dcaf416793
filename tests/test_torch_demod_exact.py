"""The port's per-sample parity chain (mode="exact", rx/demod.py), its FIR
and loop helpers (core/fir.py, core/loops.py) on the CPU against
tetra_tpu's, on the same seeded numpy inputs.

Tolerances, from readings over seeds 0-4 (six blocks of 1024 on three
channels at ~26 dB): the FIR outputs differ from JAX's by <= 2e-7
(conv1d vs XLA's conv, float32); the chain's dibits and valid are equal
throughout; its loop state drifts from the reference's by <= 1e-3
(phases modulo 2 pi: the FLL and Costas phases integrate last-bit
differences of sin/cos and of the tap sums' order), so state is held to
2e-3.  Symbols and dist agree to ~1e-6 until floor(mu * 128) falls on
the other side of an integer at some slot: the interpolator takes the
adjacent polyphase row there (a step of up to 8.7e-3 in the readings),
and the timing loop carries the difference on for a while.  The share
of slots within 1e-4 read >= 0.899 per block (seed 4's sixth block; 1.0
on most).  So floats are held to 1e-4 on >= 80% of each block's slots
and to 2e-2 (one row step at unit amplitude, with margin) on all."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu.core import fir as JFIR
from tetra_tpu.core import loops as JL
from tetra_tpu.rx import demod as JD
from tetra_tpu_torch.core import fir as TFIR
from tetra_tpu_torch.core import loops as TL
from tetra_tpu_torch.rx import demod as TD
from tetra_tpu_torch.tx.modulator import modulate
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

TOL_FIR = 1e-5
TOL_FLOAT = 1e-4          # on >= FLOAT_SHARE of the slots
FLOAT_SHARE = 0.8
TOL_FLOAT_ROW = 2e-2      # on every slot: one interpolator-row step
TOL_STATE = 2e-3
PHASES = ("fll_phase", "cos_phase", "cos_ph2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signal(rng, shape, kind):
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "complex":
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


@pytest.mark.parametrize("xk", ["real", "complex"])
@pytest.mark.parametrize("hk", ["real", "complex"])
def test_fir_valid_matches_jax(xk, hk):
    rng = np.random.default_rng(1)
    x, h = _signal(rng, (3, 300), xk), _signal(rng, (17,), hk)
    ref = np.asarray(JFIR.fir_valid(jnp.asarray(x), jnp.asarray(h)))
    got = TFIR.fir_valid(_t(x), _t(h)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (3, 284)
    np.testing.assert_allclose(got, ref, atol=TOL_FIR)


def test_fir_stream_and_tail_match_jax():
    rng = np.random.default_rng(2)
    h = _signal(rng, (9,), "complex")
    jt, tt = JFIR.make_fir_tail(2, 9), TFIR.make_fir_tail(2, 9, device="cpu")
    assert tuple(tt.shape) == jt.shape and tt.dtype == torch.complex64
    for _ in range(3):
        x = _signal(rng, (2, 100), "complex")
        jy, jt = JFIR.fir_stream(jnp.asarray(x), jnp.asarray(h), jt)
        ty, tt = TFIR.fir_stream(_t(x), _t(h), tt)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL_FIR)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_fir_stream_pair_mm_matches_jax():
    rng = np.random.default_rng(3)
    h = TD._tables()[0]
    tails = [np.zeros((2, 64), np.float32)] * 2
    jtails = tails
    for _ in range(3):
        xr, xi = _signal(rng, (2, 512), "real"), _signal(rng, (2, 512), "real")
        j = JFIR.fir_stream_pair_mm(jnp.asarray(xr), jnp.asarray(xi),
                                    jnp.asarray(h), *map(jnp.asarray, jtails))
        t = TFIR.fir_stream_pair_mm(_t(xr), _t(xi), _t(h), *map(_t, tails))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_FIR)
        jtails, tails = [np.asarray(a) for a in j[2:]], [a.numpy()
                                                          for a in t[2:]]
    with pytest.raises(ValueError, match="65-tap"):
        TFIR.fir_stream_pair_mm(_t(xr[:, :500]), _t(xi[:, :500]), _t(h),
                                *map(_t, tails))


@pytest.mark.parametrize("wrap", [True, False])
def test_loops_match_jax(wrap):
    for bw in (0.01, 0.00628, 0.3):
        assert TL.critically_damped(bw) == JL.critically_damped(bw)
        assert TL.critically_damped(bw, 0.5) == JL.critically_damped(bw, 0.5)
    rng = np.random.default_rng(4)
    ph = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    fr = rng.uniform(-0.1, 0.1, 64).astype(np.float32)
    js, ts = JL.PCLState(jnp.asarray(ph), jnp.asarray(fr)), \
        TL.PCLState(_t(ph), _t(fr))
    for _ in range(20):
        err = rng.uniform(-1, 1, 64).astype(np.float32)
        js = JL.pcl_advance(js, jnp.asarray(err), 0.05, 0.002, -0.08, 0.08,
                            wrap_phase=wrap)
        ts = TL.pcl_advance(ts, _t(err), 0.05, 0.002, -0.08, 0.08,
                            wrap_phase=wrap)
    np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq),
                               atol=TOL_FIR)
    np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase),
                               atol=TOL_FIR)


def air(channels: int, n_bits: int, seed: int = 0) -> np.ndarray:
    """Modulated downlink-like air: random bits, a CFO per channel (+-300
    Hz), gains and phases, complex Gaussian noise at ~26 dB (numpy)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (channels, n_bits)).astype(np.uint8)
    iq = modulate(bits, device="cpu").numpy()
    n = np.arange(iq.shape[1])
    cfo = rng.uniform(-300, 300, (channels, 1))
    g = rng.uniform(0.5, 2.0, (channels, 1))
    iq = iq * g * np.exp(1j * (2 * np.pi * cfo / 36000 * n
                               + rng.uniform(0, 6, (channels, 1))))
    noise = rng.standard_normal(iq.shape) + 1j * rng.standard_normal(iq.shape)
    return (iq + 0.035 * g * noise).astype(np.complex64), bits


def _floats_close(a, b, name):
    d = np.abs(np.asarray(a, np.float64) - b)
    assert d.max() <= TOL_FLOAT_ROW, (name, d.max())
    assert (d <= TOL_FLOAT).mean() >= FLOAT_SHARE, (name, np.sort(d)[-20:])


def _state_close(ts, js, tol=TOL_STATE):
    for k, v in js._asdict().items():
        a, b = getattr(ts, k).numpy(), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        d = np.abs(a.astype(np.float64) - b)
        if k in PHASES:
            d = np.minimum(d, 2 * np.pi - d)
        assert d.max() <= tol, (k, d.max())


def test_agc_fll_scan_matches_jax():
    x, _ = air(3, 2048, seed=5)
    _, be, _ = TD._tables()
    rng = np.random.default_rng(6)
    st = [np.full(3, 1.3, np.float32), rng.uniform(-3, 3, 3).astype(
        np.float32), rng.uniform(-0.05, 0.05, 3).astype(np.float32),
        rng.standard_normal((3, 64)).astype(np.float32),
        rng.standard_normal((3, 64)).astype(np.float32)]
    xr, xi = x.real.copy(), x.imag.copy()
    j = JD._agc_fll_scan(jnp.asarray(xr), jnp.asarray(xi),
                         *map(jnp.asarray, st), be)
    t = TD._agc_fll_scan(_t(xr), _t(xi), *map(_t, st), be)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_STATE)


def test_mm_costas_scan_matches_jax():
    x, _ = air(3, 2200, seed=7)
    rrc, _, bank = TD._tables()
    y = TFIR.fir_valid(_t(x), _t(rrc)).numpy()[:, :1024]
    rng = np.random.default_rng(8)
    st = [np.zeros((3, 7), np.float32)] * 2 + [
        np.array([0, 1, 2], np.int32), rng.uniform(0, 1, 3).astype(
            np.float32), np.full(3, 2.0, np.float32),
        rng.uniform(-3, 3, 3).astype(np.float32),
        rng.uniform(-0.05, 0.05, 3).astype(np.float32),
        rng.uniform(-6, 0, 3).astype(np.float32),
        np.array([0, 3, 1], np.int32)]
    yr, yi = y.real.copy(), y.imag.copy()
    n = TD.max_symbols(1024)
    assert n == JD.max_symbols(1024)
    j = JD._mm_costas_scan(jnp.asarray(yr), jnp.asarray(yi),
                           *map(jnp.asarray, st), bank, n)
    t = TD._mm_costas_scan(_t(yr), _t(yi), *map(_t, st), bank, n)
    for k in ("dibits", "valid"):
        np.testing.assert_array_equal(t[0][k].numpy(), np.asarray(j[0][k]))
    for k in ("sym_re", "sym_im", "dist"):
        _floats_close(t[0][k].numpy(), np.asarray(j[0][k]), k)
    for a, b in zip(t[1:], j[1:]):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_STATE)


@pytest.mark.parametrize("seed", [0, 1])
def test_demod_block_stream_matches_jax(seed):
    """C = 3, 6 blocks of 1024: the per-block outputs and the carried
    state agree with the JAX chain's."""
    x, _ = air(3, 12288, seed=seed)
    js, ts = JD.demod_init(3), TD.demod_init(3, "cpu")
    seen = 0
    for b in range(6):
        blk = x[:, b * 1024:(b + 1) * 1024]
        js, jo = JD.demod_block(js, blk)
        ts, to = TD.demod_block(ts, blk)
        np.testing.assert_array_equal(to["valid"].numpy(),
                                      np.asarray(jo["valid"]))
        v = to["valid"].numpy()
        d_t, d_j = to["dibits"].numpy(), np.asarray(jo["dibits"])
        for c in range(3):
            skip = max(0, 256 - seen)
            np.testing.assert_array_equal(d_t[c][v[c]][skip:],
                                          d_j[c][v[c]][skip:])
        seen += int(v.sum(axis=1).min())
        for k in ("sym_re", "sym_im", "dist"):
            _floats_close(to[k].numpy(), np.asarray(jo[k]), k)
        for k in ("fll_freq", "agc_gain"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=TOL_FLOAT, err_msg=k)
        _state_close(ts, js)


def _demod_stream(iq, block):
    state = TD.demod_init(iq.shape[0], "cpu")
    dibs, vals = [], []
    for i in range(iq.shape[1] // block):
        state, outs = TD.demod_block(state, iq[:, i * block:(i + 1) * block])
        dibs.append(outs["dibits"].numpy())
        vals.append(outs["valid"].numpy())
    return np.concatenate(dibs, 1), np.concatenate(vals, 1)


def _ber_after_convergence(tx_bits, rx_bits, skip=1000, probe=400):
    pat = tx_bits[skip:skip + probe]
    errs = [np.mean(rx_bits[o:o + probe] != pat)
            for o in range(len(rx_bits) - probe)]
    off = int(np.argmin(errs))
    n = min(len(rx_bits) - off, len(tx_bits) - skip)
    return float(np.mean(rx_bits[off:off + n] != tx_bits[skip:skip + n]))


def test_block_size_invariance():
    """Streaming in different block sizes yields the same symbol stream
    (state continuity across block boundaries; tests/test_demod.py's case
    on the port)."""
    bits = np.random.default_rng(0).integers(0, 2, (1, 8000)).astype(np.uint8)
    iq = modulate(bits, device="cpu").numpy()
    dib_a, val_a = _demod_stream(iq[:, :4096], block=1024)
    dib_b, val_b = _demod_stream(iq[:, :4096], block=512)
    a, b = dib_a[0][val_a[0]], dib_b[0][val_b[0]]
    n = min(len(a), len(b))
    assert n > 1900 and (a[:n] == b[:n]).all()


def test_multichannel_independent():
    """Channels in one batch demodulate independently and identically to a
    single-channel run, and error-free after convergence."""
    bits = np.random.default_rng(1).integers(0, 2, (3, 6000)).astype(
        np.uint8)
    iq = modulate(bits, device="cpu").numpy()
    gains = np.array([0.5, 1.0, 2.0])[:, None]
    phases = np.exp(1j * np.array([0.3, -1.0, 2.2]))[:, None]
    iq3 = (iq * gains * phases).astype(np.complex64)
    dib, val = _demod_stream(iq3, block=1024)
    solo_dib, solo_val = _demod_stream(iq3[1:2], block=1024)
    assert (dib[1][val[1]] == solo_dib[0][solo_val[0]]).all()
    for c in range(3):
        rx_bits = TD.dibits_to_bits(dib[c][val[c]])
        assert _ber_after_convergence(bits[c], rx_bits) == 0.0, c


def test_demod_init_needs_cuda_or_cpu():
    st = TD.demod_init(2, "cpu")
    assert st.mm_offset.dtype == torch.int32 and st.prev_sym.dtype == \
        torch.int32 and st.mm_freq.tolist() == [2.0, 2.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            TD.demod_init(2)
