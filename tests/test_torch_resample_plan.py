"""The tile plan of K3's resample kernel (csrc/chan.cu:resample_kernel) on
the CPU.

The kernel cannot run here, so its plan is mirrored in numpy and run block
by block over the whole grid: which stream rows a block stages (and which
of them come from the history h), the phase and the staged row of each tap
of each output a warp makes, the masked lanes past C, and which block
writes the next block's history from which rows.  Shared memory starts as
NaN, so an output that reads a row its block did not stage comes out NaN.
The mirror is held against channelizer._resample_stream_block_fm (the
wrapper's plain version) over two chained blocks, at 1e-4 x RMS as
chip_smoke.py holds the kernel (float32 sums in another order than the
plain version's superblock matrix product); the tails must be equal.  An
off-by-one in the staging window or in the tails fails here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu.parallel import channelizer as JCH
from tetra_tpu_torch.ops import chan_kernel as CK

# resample_kernel's constants (csrc/chan.cu RS_*)
L, M, TAPS, PAD = 18, 25, 24, 23
CT, G, THREADS = 32, 8, 256
WARPS = THREADS // 32
ROWS = M * G + PAD


def _taps():
    _, _, coef, off = CK._tables(16, "cpu")
    return coef.numpy(), off.numpy()


def _kernel_plan(y, h, coef, off):
    """resample_kernel's plan in numpy: y (2, t_in, C), h (2, PAD, C) ->
    rows (2, t_out, C) and tails (2, PAD, C), with every block of the grid
    (ceil(C / CT), ceil(t_in / M / G)) run in turn."""
    t_in, C = y.shape[1:]
    assert t_in % M == 0
    n_q = t_in // M
    tiles, ctiles = -(-n_q // G), -(-C // CT)
    assert tiles <= 65535
    out = np.full((2, n_q * L, C), np.nan, np.float32)
    tails = np.full((2, PAD, C), np.nan, np.float32)
    n_out = np.zeros((n_q * L, C), np.int64)
    n_tail = np.zeros((PAD, C), np.int64)
    for by in range(tiles):
        q0 = by * G
        g = min(G, n_q - q0)
        e0, rows = q0 * M, g * M + PAD
        assert rows <= ROWS
        assert e0 + rows <= PAD + t_in          # inside the stream
        assert g < G or by < tiles - 1 or e0 + rows == PAD + t_in
        e = e0 + np.arange(rows)
        hist = e < PAD
        # only the first tile's first PAD rows come from the history
        assert hist.sum() == (PAD if by == 0 else 0)
        for bx in range(ctiles):
            c = bx * CT + np.arange(CT)
            live = c < C
            cl = c[live]
            sm = np.full((2, ROWS, CT), np.nan, np.float32)
            for k in range(2):
                sm[k, np.flatnonzero(hist)[:, None], np.flatnonzero(live)] = \
                    h[k][e[hist]][:, cl]
                sm[k, np.flatnonzero(~hist)[:, None], np.flatnonzero(live)] = \
                    y[k][e[~hist] - PAD][:, cl]
            for w in range(WARPS):
                j = np.arange(w, g * L, WARPS)      # warp w: j = w + 8 i
                ql, p = j // L, j % L
                r = ql[:, None] * M + off[p][:, None] + np.arange(TAPS)
                assert r.max() < rows                # a staged row
                for k in range(2):
                    v = sm[k][r][..., live]          # (len j, TAPS, lanes)
                    acc = np.zeros((len(j), len(cl)), np.float32)
                    for t in range(TAPS):            # tap order
                        acc = acc + coef[p, t][:, None] * v[:, t]
                    out[k][np.ix_(q0 * L + j, cl)] = acc
                n_out[np.ix_(q0 * L + j, cl)] += 1
            if by == tiles - 1:
                # stream rows t_in .. t_in + PAD - 1: y's last PAD rows
                assert e0 + g * M == t_in
                for k in range(2):
                    tails[k][:, cl] = sm[k, g * M:g * M + PAD][:, live]
                n_tail[:, cl] += 1
    assert (n_out == 1).all() and (n_tail == 1).all()
    return out, tails


@pytest.mark.parametrize("n_ch, t50", [
    (16, 25), (16, 775), (16, 6400), (48, 25), (48, 775), (48, 6400),
    (256, 25), (256, 775), (256, 6400), (16, 91025)])
def test_resample_plan_matches_plain(n_ch, t50):
    """One group (t50 = 25), 31 groups in a ragged last tile (775), the
    main path's 256 groups (6400), and t36 = 65538 at n_ch = 16 (the old
    kernel's grid refused t36 > 65535); C = 16 and 48 leave masked lanes.
    Two chained blocks: the second's history is the first's tails."""
    rng = np.random.default_rng(n_ch + t50)
    t36 = t50 * L // M
    coef, off = _taps()
    h = rng.standard_normal((2, PAD, n_ch)).astype(np.float32)
    hp = tuple(torch.from_numpy(a) for a in h)
    for _ in range(2):
        y = rng.standard_normal((2, t50, n_ch)).astype(np.float32)
        rows, tails = _kernel_plan(y, h, coef, off)
        ref = CK.resample(*(torch.from_numpy(a) for a in y), *hp, t36)
        rms = float(np.sqrt((ref[0].numpy() ** 2
                             + ref[1].numpy() ** 2).mean()))
        for k in range(2):
            assert np.isfinite(rows[k]).all()
            assert np.abs(rows[k] - ref[k].numpy()).max() <= 1e-4 * rms
            np.testing.assert_array_equal(tails[k], ref[2 + k].numpy())
            np.testing.assert_array_equal(tails[k], y[k][-PAD:])
        h, hp = tails, ref[2:]


@pytest.mark.parametrize("C, t50", [(16, 800), (7, 75)])
def test_resample_wrapper_matches_jax(C, t50):
    """CK.resample on CPU tensors against the JAX package's frame-major
    streaming resampler, atol 3e-5 as tests/test_torch_front_end.py."""
    rng = np.random.default_rng(C)
    t36 = t50 * L // M
    x = rng.standard_normal((2, t50, C)).astype(np.float32)
    h = rng.standard_normal((2, PAD, C)).astype(np.float32)
    ref = JCH._resample_stream_block_fm(*(jnp.asarray(a) for a in x),
                                        *(jnp.asarray(a) for a in h), t36)
    got = CK.resample(*(torch.from_numpy(a) for a in x),
                      *(torch.from_numpy(a) for a in h), t36)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)
