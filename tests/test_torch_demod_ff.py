"""The port's feedforward block receiver (mode="ff", rx/demod_ff.py) and
demod_fast.rot_ramp_outer on the CPU against tetra_tpu's, on the same
seeded numpy inputs.

Tolerances, from readings over seeds 0-4 (three blocks of 4608 on two
channels): dibits and valid equal; symbols within 2.3e-4 and dist on valid
slots within 2.2e-4 (dist past the valid prefix, where the symbols are
near zero, is not compared); the carried state within 8.5e-4, phases
modulo 2 pi.  These are last-bit differences at large magnitudes, not
algorithmic ones: the next-block anchors are computed at |ph2 - pi/4 *
n_valid| ~ 1800 rad and |w T| ~ 200 rad, where one float32 ulp is 1.2e-4
and 1.5e-5 rad (the reference's compiled CPU code rounds some
multiply-adds once, the port's eager ops twice), and a symbol position p
~ 4600 samples carries its fractional phase at float32's 4.9e-4 ulp.  So
floats are held to 1e-3 and state to 2e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu.rx import demod_fast as JDF
from tetra_tpu.rx import demod_ff as JFF
from tetra_tpu_torch.rx import demod_fast as TDF
from tetra_tpu_torch.rx import demod_ff as TFF
from tests.test_torch_demod_exact import air
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

TOL = 1e-3
TOL_STATE = 2e-3
PHASES = ("rot_phase", "phi_anchor", "ph2")
T = 4608


def _outs_close(to, jo):
    v = to["valid"].numpy()
    np.testing.assert_array_equal(v, np.asarray(jo["valid"]))
    np.testing.assert_array_equal(to["dibits"].numpy(),
                                  np.asarray(jo["dibits"]))
    for k in ("sym_re", "sym_im", "fll_freq", "agc_gain"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(to["dist"].numpy()[v],
                               np.asarray(jo["dist"])[v], atol=TOL)


def _state_close(ts, js):
    for k, v in js._asdict().items():
        a, b = getattr(ts, k).numpy(), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        d = np.abs(a.astype(np.float64) - b)
        if k in PHASES:
            d = np.minimum(d, 2 * np.pi - d)
        assert d.max() <= TOL_STATE, (k, d.max())


@pytest.mark.parametrize("seed", [0, 1])
def test_demod_block_matches_jax(seed):
    """C = 2, three blocks of 4608: outputs and carried state."""
    x, _ = air(2, 3 * T, seed=seed)
    js, ts = JFF.demod_init(2), TFF.demod_init(2, "cpu")
    for b in range(3):
        blk = x[:, b * T:(b + 1) * T]
        js, jo = JFF.demod_block(js, blk)
        ts, to = TFF.demod_block(ts, blk)
        _outs_close(to, jo)
        _state_close(ts, js)


def test_demod_blocks_equal_per_block_calls():
    x, _ = air(2, 3 * 2048, seed=2)
    stack = np.stack([x[:, i * 2048:(i + 1) * 2048] for i in range(3)])
    st_b, outs_b = TFF.demod_blocks(TFF.demod_init(2, "cpu"), stack)
    st = TFF.demod_init(2, "cpu")
    for i in range(3):
        st, o = TFF.demod_block(st, stack[i])
        for k in o:
            assert torch.equal(outs_b[k][i], o[k]), k
    for a, b in zip(st_b, st):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="multiple of 512"):
        TFF.demod_block(st, x[:, :1000])


def test_multiblock_streaming_is_seam_free():
    """Block-by-block feeding emits the one-call stream's symbols after the
    first 256 (tests/test_demod_ff.py's case on the port)."""
    bits = np.random.default_rng(21).integers(0, 2, (1, 30_000)).astype(
        np.uint8)
    from tetra_tpu_torch.tx.modulator import modulate
    iq = modulate(bits, device="cpu").numpy()
    n = iq.shape[1] // T
    _, o1 = TFF.demod_block(TFF.demod_init(1, "cpu"), iq[:, :n * T])
    d1 = o1["dibits"][0][o1["valid"][0]].numpy()
    st, parts = TFF.demod_init(1, "cpu"), []
    for i in range(n):
        st, o = TFF.demod_block(st, iq[:, i * T:(i + 1) * T])
        parts.append(o["dibits"][0][o["valid"][0]].numpy())
    d2 = np.concatenate(parts)
    m = min(len(d1), len(d2))
    assert abs(len(d1) - len(d2)) <= 2 and m > 10_000
    assert (d1[256:m] == d2[256:m]).all()


@pytest.mark.parametrize("K", [64, 4608])
def test_rot_ramp_outer_matches_jax(K):
    rng = np.random.default_rng(K)
    ph = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    fr = rng.uniform(-0.3, 0.3, 5).astype(np.float32)
    jc, js = JDF.rot_ramp_outer(jnp.asarray(ph), jnp.asarray(fr), K)
    tc, ts = TDF.rot_ramp_outer(torch.from_numpy(ph), torch.from_numpy(fr), K)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    exact = ph[:, None] + fr[:, None] * np.arange(K)
    np.testing.assert_allclose(tc.numpy(), np.cos(exact), atol=2e-4)


def test_tables_and_segment_sums_match_jax():
    """The half-sample taps and the interpolation matrices are bit-equal,
    and the port's reshape sums equal the reference's operator matrix."""
    np.testing.assert_array_equal(TFF._half_sample_taps(),
                                  JFF._half_sample_taps())
    for n_sym, n_seg in ((2308, 9), (2052, 8), (100, 1)):
        np.testing.assert_array_equal(TFF._interp_matrix(n_sym, n_seg),
                                      JFF._interp_matrix(n_sym, n_seg))
    rng = np.random.default_rng(9)
    g2, h2 = rng.random((2, 3, T), dtype=np.float32)
    M = JFF._om_matrix(T, 9)
    re, im = TFF._om_sums(torch.from_numpy(g2), torch.from_numpy(h2), 9)
    np.testing.assert_allclose(re.numpy(), g2 @ M[:, :9], atol=1e-3)
    np.testing.assert_allclose(im.numpy(), h2 @ M[:, 9:], atol=1e-3)
