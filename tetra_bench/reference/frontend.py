"""Plain reference of the wideband front end: polyphase DFT filterbank
(N channels of 50 kHz, 2x oversampled, hop N/2) and the streaming 18/25
resampler to 36 kHz, computed from the raw air in any dtype (float64 for
the reference, bfloat16 for its control).

Filters are designed here from their definitions, not taken from the
program: the filterbank prototype is a Nuttall-windowed sinc of N x 48
taps with cutoff 0.53 / N, scaled to a DC gain of N; the resampler is a
Nuttall-windowed sinc of 18 x 24 taps with cutoff 0.48 / 25, scaled to a
DC gain of 18.  The 50 kHz frame F of a stream is

    y[F, k] = (-1)^(F k) sum_b f[F, b] exp(-2 pi i b k / N),
    f[F, d hop + c] = sum_j h[(2 j + d) hop + c] x[(F + 2 j + d) hop + c]

(d = 0, 1; c < hop = N / 2; frame F starts at air sample F hop), and the 36
kHz output n of a block is sum_t g[(25 n) mod 18][23 - t] s[25 n // 18 + t]
over s = (the block's 23 frames of history, then its frames).
"""

from __future__ import annotations

import numpy as np
import torch

TAPS_PER_BRANCH = 48
RS_TAPS = 24
RS_L, RS_M = 18, 25


def nuttall(n: np.ndarray, N: int) -> np.ndarray:
    x = 2.0 * np.pi * n / (N - 1)
    return (0.355768 - 0.487396 * np.cos(x) + 0.144232 * np.cos(2 * x)
            - 0.012604 * np.cos(3 * x))


def _windowed_sinc(total: int, cutoff: float) -> np.ndarray:
    n = np.arange(total)
    c = (total - 1) / 2.0
    return 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, total)


def prototype(n_ch: int) -> np.ndarray:
    h = _windowed_sinc(n_ch * TAPS_PER_BRANCH, 0.53 / n_ch)
    return h / h.sum() * n_ch


def resample_bank() -> np.ndarray:
    """(18, 24): the resampler's polyphase bank, phase p = taps p::18."""
    h = _windowed_sinc(RS_L * RS_TAPS, 0.48 / max(RS_L, RS_M))
    h = h * (RS_L / h.sum())
    return np.stack([h[p::RS_L] for p in range(RS_L)])


def channel_frames(xr, xi, n_ch: int, count: int, dtype, parity0: int):
    """`count` 50 kHz frames of every channel from the air xr/xi (real
    planes starting at the first frame's first sample, at least (count +
    95) x hop long), frame-major (count, n_ch) real and imaginary planes
    in `dtype`; parity0 is the first frame's index mod 2, for the
    (-1)^(F k) flip."""
    hop = n_ch // 2
    n_s = 2 * TAPS_PER_BRANCH
    dev = xr.device
    F = torch.from_numpy(prototype(n_ch).reshape(n_s, hop)).to(dev, dtype)
    zr = xr[:(count + n_s - 1) * hop].to(dtype).reshape(-1, hop)
    zi = xi[:(count + n_s - 1) * hop].to(dtype).reshape(-1, hop)
    acc = [[None, None], [None, None]]          # [re/im][half d]
    for s in range(n_s):
        d = s % 2
        for q, z in ((0, zr), (1, zi)):
            term = z[s:s + count] * F[s]
            acc[q][d] = term if acc[q][d] is None else acc[q][d] + term
    fr, fi = torch.cat(acc[0], dim=1), torch.cat(acc[1], dim=1)
    k = np.arange(n_ch)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n_ch)
    Wr = torch.from_numpy(W.real.copy()).to(dev, dtype)
    Wi = torch.from_numpy(W.imag.copy()).to(dev, dtype)
    yr = fr @ Wr - fi @ Wi
    yi = fr @ Wi + fi @ Wr
    m = torch.arange(count, device=dev)[:, None]
    flip = torch.where(((m + parity0) * torch.arange(n_ch, device=dev)[None])
                       % 2 == 1,
                       -1.0, 1.0).to(dtype)
    return yr * flip, yi * flip


def resample(sr, si, t36: int, dtype):
    """(23 + t50, C) history-then-block 50 kHz planes -> (t36, C)."""
    bank = resample_bank()
    n = np.arange(t36)
    base = torch.from_numpy((n * RS_M) // RS_L).to(sr.device)
    coef = torch.from_numpy(bank[(n * RS_M) % RS_L][:, ::-1].copy()).to(
        sr.device, dtype)                           # (t36, 24)
    outr = outi = None
    for t in range(RS_TAPS):
        w = coef[:, t:t + 1]
        tr, ti = sr[base + t] * w, si[base + t] * w
        outr = tr if outr is None else outr + tr
        outi = ti if outi is None else outi + ti
    return outr, outi


def front_end(xr, xi, n_ch: int, t50: int, t36: int, dtype):
    """The 36 kHz output of one block: xr/xi the air from 23 frames before
    the block's first frame, at least (t50 + 23 + 95) x hop samples; the
    block's first frame has an even index (t50 is even).  Returns (t36,
    n_ch) planes in `dtype`."""
    pad = RS_TAPS - 1
    yr, yi = channel_frames(xr, xi, n_ch, t50 + pad, dtype, pad % 2)
    return resample(yr, yi, t36, dtype)
