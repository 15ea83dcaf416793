"""Polyphase DFT-filterbank channelizer + 18/25 rational resampler (port of
tetra_tpu/parallel/channelizer.py).

A wideband capture at fs = N x 25 kHz splits into N channels of 50 kHz
complex baseband (2x oversampled polyphase bank, hop N/2), then an 18/25
polyphase resampler brings each to the demod's 36 kHz.  The tables are
computed by the reference's numpy code; the fold + DFT + flip runs as the
K4 kernel and the whole front end as K3 (ops/chan_kernel.py).  resample()
is the reference's public block resampler (any L/M; the audio output's
8 kHz -> 48 kHz), a banded matrix product in plain torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import resolve_device
from ..core.taps import nuttall

TAPS_PER_BRANCH = 48
RS_TAPS_PER_PHASE = 24


@lru_cache(maxsize=8)
def _prototype(n_ch: int, taps_per_branch: int = TAPS_PER_BRANCH) -> np.ndarray:
    """Lowpass prototype for the filterbank: Nuttall-windowed sinc, cutoff
    0.53/n_ch (TETRA band edge flat, -71 dB adjacent-channel rejection)."""
    L = n_ch * taps_per_branch
    n = np.arange(L)
    c = (L - 1) / 2.0
    cutoff = 0.53 / n_ch
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, L)
    h = h / h.sum() * n_ch
    return h.astype(np.float32)


@lru_cache(maxsize=8)
def _dft_basis(n_ch: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n_ch)
    # negative exponent: channel k extracts +k*25 kHz
    W = np.exp(-2j * np.pi * np.outer(k, k) / n_ch)
    return (W.real.astype(np.float32), W.imag.astype(np.float32))


def _channelize_block_impl(xr, xi, n_ch: int, frame_major: bool = False):
    """(T,) wideband float pair -> (n_ch, T//(n_ch//2)) channel pairs
    ((t50, n_ch) if frame_major).  2x oversampled: hop = n_ch//2; the input
    must satisfy (T - L) % hop == 0 with L = n_ch*TAPS_PER_BRANCH.  Runs the
    K4 kernel (ops/chan_kernel.fold_dft) on CUDA tensors."""
    from ..ops.chan_kernel import fold_dft
    hop = n_ch // 2
    L = n_ch * TAPS_PER_BRANCH
    T = xr.shape[0]
    n_out = (T - L) // hop + 1
    n_z = T // hop
    need = n_out + 2 * TAPS_PER_BRANCH - 1
    zr = xr[:n_z * hop].reshape(n_z, hop)[:need]
    zi = xi[:n_z * hop].reshape(n_z, hop)[:need]
    yr, yi = fold_dft(zr.contiguous(), zi.contiguous(), n_ch)
    if frame_major:
        return yr, yi
    return yr.T, yi.T


def _front_end_block(xr, xi, hr, hi, n_ch: int, t36: int):
    """Whole wideband front end for one block: channelize + streaming 18/25
    resample, frame-major.  xr/xi: (wide_len,) wideband rows; hr/hi:
    (RS_TAPS_PER_PHASE-1, n_ch) stream history.  Returns (rr (t36, n_ch),
    ri, hr2, hi2).

    Runs K3 (ops/chan_kernel.fold_dft_resample) on CUDA tensors: the K4
    kernel (fold + DFT + flip), then the resample kernel, which also
    writes hr2/hi2; two launches behind one call.
    The reference forks on its 800-row Pallas tile; the port's kernels
    need only t50 % 25 == 0, so every block takes this one path."""
    from ..ops.chan_kernel import fold_dft_resample
    hop = n_ch // 2
    n_z = xr.shape[0] // hop
    n_out = (xr.shape[0] - n_ch * TAPS_PER_BRANCH) // hop + 1
    need = n_out + 2 * TAPS_PER_BRANCH - 1
    zr = xr[:n_z * hop].reshape(n_z, hop)[:need].contiguous()
    zi = xi[:n_z * hop].reshape(n_z, hop)[:need].contiguous()
    return fold_dft_resample(zr, zi, hr, hi, n_ch, t36)


def channelize(iq: np.ndarray, n_ch: int, device=None) -> np.ndarray:
    """Host-facing: wideband complex (T,) at n_ch*25 kHz -> (n_ch, T2)
    complex at 50 kHz per channel, computed on `device` (the current CUDA
    device unless the caller asks for the CPU)."""
    iq = np.asarray(iq)
    device = resolve_device(device)
    xr = torch.from_numpy(iq.real.astype(np.float32)).to(device)
    xi = torch.from_numpy(iq.imag.astype(np.float32)).to(device)
    yr, yi = _channelize_block_impl(xr, xi, n_ch)
    return yr.cpu().numpy() + 1j * yi.cpu().numpy()


# ---------------------------------------------------------------------------
# Rational polyphase resampler (50 kHz -> 36 kHz: L=18, M=25)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _resamp_bank(L: int, M: int) -> np.ndarray:
    """Polyphase bank for rational L/M resampling: Nuttall-windowed sinc at
    0.48x the lower Nyquist, RS_TAPS_PER_PHASE taps per phase."""
    total = L * RS_TAPS_PER_PHASE
    n = np.arange(total)
    c = (total - 1) / 2.0
    cutoff = 0.48 / max(L, M)
    h = 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, total)
    h = h * (L / h.sum())
    bank = np.zeros((L, RS_TAPS_PER_PHASE), np.float64)
    for p in range(L):
        bank[p] = h[p::L]
    return bank.astype(np.float32)


@lru_cache(maxsize=8)
def _resamp_matrix(L: int, M: int) -> tuple[np.ndarray, int, int]:
    """Banded resampling matrix W (B*M, L) with output q*L + p =
    sum_j xpp[q*M + j] W[j, p] over the ZF-front-padded stream, and
    W[ZF + floor(p*M/L) + t, p] = flip(bank[(p*M) % L])[t].
    Returns (W, B, ZF)."""
    bank = _resamp_bank(L, M)
    pad = RS_TAPS_PER_PHASE - 1
    B = 1 + -(-pad // M)
    ZF = (B - 1) * M - pad
    W = np.zeros((B * M, L), np.float32)
    for p in range(L):
        off = (p * M) // L
        coef = bank[(p * M) % L][::-1]
        for t in range(RS_TAPS_PER_PHASE):
            W[ZF + off + t, p] += coef[t]
    return W, B, ZF


def _resample_matmul(xpp_r, xpp_i, Wm, n_q: int, B: int, M: int, L: int):
    """xpp: (..., (n_q+B-1)*M) padded stream pair -> (..., n_q*L) outputs."""
    shp = xpp_r.shape[:-1]

    def run(x):
        z = x.reshape(shp + (n_q + B - 1, M))
        zb = torch.cat([z[..., k:k + n_q, :] for k in range(B)], dim=-1)
        return (zb @ Wm).reshape(shp + (n_q * L,))

    return run(xpp_r), run(xpp_i)


def _resample_block(xr, xi, n_in: int, L: int, M: int):
    """y[n] = sum_k x[base - k] h[r + k L] with base = floor(nM/L),
    r = nM % L: a window running backward from base over a (taps-1)-zero
    padded input, computed as the banded matmul of _resamp_matrix."""
    Wnp, B, _ = _resamp_matrix(L, M)
    n_out = (n_in - RS_TAPS_PER_PHASE) * L // M
    n_q = -(-n_out // L)
    need = (n_q + B - 1) * M
    front = (B - 1) * M  # = ZF + pad: zero history + window alignment

    def framed(x):
        x = torch.cat([x.new_zeros(x.shape[:-1] + (front,)), x], dim=-1)
        if x.shape[-1] < need:
            return torch.cat(
                [x, x.new_zeros(x.shape[:-1] + (need - x.shape[-1],))],
                dim=-1)
        return x[..., :need]

    yr, yi = _resample_matmul(framed(xr), framed(xi),
                              torch.from_numpy(Wnp).to(xr.device), n_q, B,
                              M, L)
    return yr[..., :n_out], yi[..., :n_out]


def resample(iq: np.ndarray, L: int, M: int, device=None) -> np.ndarray:
    """(C, T) complex at fs -> (C, ~T*L/M) complex at fs*L/M, computed on
    `device` (the current CUDA device unless the caller asks for the CPU).
    The banded matrix product is plain torch, as the reference computes it
    outside any Pallas kernel."""
    iq = np.atleast_2d(np.asarray(iq))
    device = resolve_device(device)
    xr = torch.from_numpy(iq.real.astype(np.float32)).to(device)
    xi = torch.from_numpy(iq.imag.astype(np.float32)).to(device)
    yr, yi = _resample_block(xr, xi, iq.shape[1], L, M)
    return yr.cpu().numpy() + 1j * yi.cpu().numpy()


def resample_50_to_36(iq: np.ndarray, device=None) -> np.ndarray:
    return resample(iq, 18, 25, device)


def resample_36_to_50(iq: np.ndarray, device=None) -> np.ndarray:
    return resample(iq, 25, 18, device)


@lru_cache(maxsize=8)
def _resamp_super_matrix(L: int, M: int, S: int) -> np.ndarray:
    """Superblock form of _resamp_matrix for frame-major streams: S output
    blocks as one (S*L, S*M + (B-1)*M) banded matrix."""
    W, B, _ = _resamp_matrix(L, M)
    WS = np.zeros((S * L, (S + B - 1) * M), np.float32)
    for u in range(S):
        WS[u * L:(u + 1) * L, u * M:u * M + B * M] = W.T
    return WS


def _resample_stream_block_fm(xr, xi, hr, hi, t_out: int, L: int = 18,
                              M: int = 25, S: int = 32):
    """Frame-major streaming resampler (plain PyTorch): xr/xi (t_in, C) new
    input rows, hr/hi (RS_TAPS_PER_PHASE-1, C) carried input tail.  Returns
    (yr (t_out, C), yi, hr2, hi2)."""
    t_in = xr.shape[0]
    if t_out * M != t_in * L:
        raise ValueError(f"t_out={t_out} does not match t_in={t_in} at {L}/{M}")
    pad = RS_TAPS_PER_PHASE - 1
    _, B, ZF = _resamp_matrix(L, M)
    n_q = t_in // M
    while n_q % S:
        S //= 2
    n_super = n_q // S
    WS = torch.from_numpy(_resamp_super_matrix(L, M, S)).to(xr.device)
    C = xr.shape[1]

    def run(x, h):
        xpp = torch.cat([x.new_zeros((ZF, C)), h, x], dim=0)
        blocks = xpp.reshape(n_q + B - 1, M, C)
        base = blocks[:n_super * S].reshape(n_super, S * M, C)
        extra = blocks[S::S].reshape(n_super, (B - 1) * M, C)
        win = torch.cat([base, extra], dim=1)       # (n_super, (S+1)M, C)
        return torch.einsum("ow,gwc->goc", WS, win).reshape(t_out, C)

    return run(xr, hr), run(xi, hi), xr[-pad:], xi[-pad:]
