"""The port's generic Viterbi engine (rx/viterbi.viterbi_decode_generic)
against tetra_tpu's, package against package: every (n, K) geometry and
termination of tests/test_viterbi_generic.py, on corrupted and punctured
codewords.  Soft values are 0 and +-1, so every path metric is exact in
float32 and the bits must be equal, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu import params as JP
from tetra_tpu.rx.viterbi import viterbi_decode as j_decode
from tetra_tpu.rx.viterbi import viterbi_decode_generic as j_generic
from tetra_tpu.tx import fec_enc
from tetra_tpu_torch.rx.viterbi import viterbi_decode as t_decode
from tetra_tpu_torch.rx.viterbi import viterbi_decode_generic as t_generic
from tests.test_viterbi_generic import GEOMETRIES, _encode, _polys

L = 96
B = 6


def _soft(polys, term: str, rng, flips: int, erase: float):
    """(B, T, n) soft codewords of B random blocks, each with `flips`
    flipped and a share `erase` of punctured (0) mother symbols; and the
    blocks' information bits."""
    n, K = polys.shape
    bits = rng.integers(0, 2, (B, L)).astype(np.uint8)
    soft = []
    for b in bits:
        full = np.concatenate([b, np.zeros(K - 1, np.uint8)]) \
            if term == "zero" else b
        m = _encode(polys, full, tailbite=term == "tailbite").copy()
        m[rng.choice(len(m), flips, replace=False)] ^= 1
        s = 1.0 - 2.0 * m.astype(np.float32)
        s[rng.random(len(s)) < erase] = 0.0
        soft.append(s.reshape(-1, n))
    return np.stack(soft), bits


def _both(soft, polys, term):
    j = np.asarray(j_generic(jnp.asarray(soft), polys, term=term))
    t = t_generic(torch.from_numpy(soft), polys, term=term)
    assert t.dtype == torch.uint8 and t.shape == soft.shape[:2]
    return t.numpy(), j


@pytest.mark.parametrize("term", ["zero", "truncate", "tailbite"])
@pytest.mark.parametrize("n,K", GEOMETRIES)
def test_generic_matches_jax(n, K, term):
    """Light corruption (the blocks decode to their bits) and heavy
    corruption (decoding errs; the two engines must err alike)."""
    polys = _polys(n, K)
    rng = np.random.default_rng(100 * n + 10 * K + len(term))
    soft, bits = _soft(polys, term, rng, flips=3, erase=0.05)
    t, j = _both(soft, polys, term)
    np.testing.assert_array_equal(t, j)
    if term == "truncate":
        # the last K-1 bits of a truncated block are weakly protected
        assert (t[:, :L - K + 1] == bits[:, :L - K + 1]).all()
    else:
        assert (t[:, :L] == bits).all()
    heavy, _ = _soft(polys, term, rng, flips=40, erase=0.3)
    t, j = _both(heavy, polys, term)
    np.testing.assert_array_equal(t, j)


def test_generic_matches_the_specialized_tetra_decoder():
    """On the TETRA K=5 codes the generic engine and the specialized
    decoder agree bit for bit, in both packages."""
    rng = np.random.default_rng(8)
    for polys, code, n, term in ((JP.CONV_CCH_POLYS, "cch", 4, "zero"),
                                 (JP.CONV_TCH_POLYS, "tch", 3, "truncate")):
        soft = rng.integers(-1, 2, (8, 112, n)).astype(np.float32)
        t, j = _both(soft, polys, term)
        np.testing.assert_array_equal(t, j)
        spec = t_decode(torch.from_numpy(soft), code, term=term).numpy()
        np.testing.assert_array_equal(spec, t)
        np.testing.assert_array_equal(
            np.asarray(j_decode(jnp.asarray(soft), code, term=term)), spec)


def test_generic_beyond_the_reference_geometry():
    """K = 8, n = 5 (outside osmo_conv's envelope): the same bits as the
    JAX engine, and the sent bits back."""
    polys = np.array([[1, 0, 1, 1, 0, 1, 1, 1],
                      [1, 1, 1, 1, 0, 0, 1, 1],
                      [1, 1, 0, 1, 1, 0, 0, 1],
                      [1, 0, 0, 1, 1, 1, 0, 1],
                      [1, 1, 1, 0, 0, 1, 0, 1]], np.uint8)
    rng = np.random.default_rng(9)
    soft, bits = _soft(polys, "zero", rng, flips=6, erase=0.0)
    t, j = _both(soft, polys, "zero")
    np.testing.assert_array_equal(t, j)
    assert (t[:, :L] == bits).all()


def test_generic_polys_as_tuple_and_bad_arguments():
    polys = _polys(2, 5)
    soft = (1.0 - 2.0 * fec_enc.conv_encode(
        np.zeros(20, np.uint8), polys).astype(np.float32)).reshape(1, -1, 2)
    as_tuple = tuple(tuple(int(x) for x in r) for r in polys)
    np.testing.assert_array_equal(
        t_generic(torch.from_numpy(soft), as_tuple).numpy(),
        t_generic(torch.from_numpy(soft), polys).numpy())
    with pytest.raises(ValueError, match="term"):
        t_generic(torch.from_numpy(soft), polys, term="flush")
    with pytest.raises(ValueError, match="outputs"):
        t_generic(torch.from_numpy(soft[..., :1]), polys)
