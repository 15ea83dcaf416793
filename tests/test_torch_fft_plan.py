"""The plan of K4's FFT kernel (csrc/chan.cu:fold_fft_kernel) on the CPU.

The kernel cannot run here, so its arithmetic is checked by mirroring it
in numpy: the twiddle table it reads (chan_kernel._tables), and a
Stockham FFT with the kernel's stage order (a radix-2 stage first when
log2 n_ch is odd, then radix-4 stages), its index maps and its twiddle
indices, run on a fold and flipped, against fold_dft_plain.  A sign,
order or twiddle error in the plan fails here.  Tolerance 1e-4 x RMS, as
chip_smoke.py holds the kernel to its plain version (float32 sums in
another order than the plain version's matrix DFT)."""

import numpy as np
import pytest
import torch

from tetra_tpu_torch.ops import chan_kernel as CK
from tetra_tpu_torch.parallel import channelizer as CH

N_CHS = [16, 32, 64, 128, 256, 512]


def _twiddles(n_ch: int) -> np.ndarray:
    tw = CK._tables(n_ch, "cpu")[1].numpy()
    return tw[:, 0] + 1j * tw[:, 1]


def _stockham(x: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """Forward DFT over the last axis by the kernel's stages: radix R after
    stages whose radices multiply to p maps x[i + r N/R] (k = i mod p),
    times tw[r k N/(p R)], through a length-R DFT to y[(i - k) R + k + r p]."""
    n = x.shape[-1]
    log2n = n.bit_length() - 1
    radices = [2] * (log2n % 2) + [4] * (log2n // 2)
    src, p = x.astype(np.complex64), 1
    for R in radices:
        q = n // R
        dst = np.empty_like(src)
        for i in range(q):
            k = i & (p - 1)
            u = [src[..., i + r * q] * tw[r * k * (n // (p * R))]
                 for r in range(R)]
            if R == 2:
                v = [u[0] + u[1], u[0] - u[1]]
            else:
                s02, d02 = u[0] + u[2], u[0] - u[2]
                s13, d13 = u[1] + u[3], u[1] - u[3]
                v = [s02 + s13, d02 - 1j * d13, s02 - s13, d02 + 1j * d13]
            j = (i - k) * R + k
            for r in range(R):
                dst[..., j + r * p] = v[r]
        src, p = dst, p * R
    assert p == n
    return src


@pytest.mark.parametrize("n_ch", N_CHS)
def test_twiddle_table_is_rounded_exponential(n_ch):
    tw = CK._tables(n_ch, "cpu")[1]
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (n_ch, 2)
    ref = np.exp(-2j * np.pi * np.arange(n_ch) / n_ch).astype(np.complex64)
    np.testing.assert_array_equal(tw[:, 0].numpy(), ref.real)
    np.testing.assert_array_equal(tw[:, 1].numpy(), ref.imag)


@pytest.mark.parametrize("n_ch", N_CHS)
def test_stockham_plan_matches_plain(n_ch):
    """Fold (tap order, as the kernel's registers sum) + the Stockham plan
    + the (-1)^(m k) flip on 37 frames against fold_dft_plain."""
    rng = np.random.default_rng(n_ch)
    hop, n_out = n_ch // 2, 37
    n_s = 2 * CH.TAPS_PER_BRANCH
    z = [rng.standard_normal((n_out + n_s - 1, hop)).astype(np.float32)
         for _ in range(2)]
    F = CK._tables(n_ch, "cpu")[0].numpy()
    zc = z[0] + 1j * z[1]
    f = np.concatenate([sum(zc[2 * j + d:2 * j + d + n_out] * F[2 * j + d]
                            for j in range(CH.TAPS_PER_BRANCH))
                        for d in (0, 1)], axis=1)
    y = _stockham(f, _twiddles(n_ch))
    m, k = np.arange(n_out)[:, None], np.arange(n_ch)[None, :]
    y = y * np.where((m * k) % 2 == 1, -1.0, 1.0)
    yr, yi = CK.fold_dft_plain(*(torch.from_numpy(a) for a in z), n_ch)
    rms = float(np.sqrt((yr.numpy() ** 2 + yi.numpy() ** 2).mean()))
    err = max(np.abs(y.real - yr.numpy()).max(),
              np.abs(y.imag - yi.numpy()).max())
    assert err <= 1e-4 * rms


@pytest.mark.parametrize("n_ch, fft", [
    (16, True), (256, True), (1024, True), (8, False), (48, False),
    (96, False), (2048, False)])
def test_fft_path_by_shape(n_ch, fft):
    """Powers of two from 16 to 1024 take the FFT kernel; any other even
    n_ch the matrix-DFT kernel."""
    assert CK._fft_path(n_ch) is fft
