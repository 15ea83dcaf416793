"""Filter tap generators (host NumPy; a copy of tetra_tpu/core/taps.py).

Semantics mirror the generators the reference chain relies on:
  - root-raised cosine:  <dsp/taps/root_raised_cosine.h> used at
    src/dsp/pi4dqpsk.cpp:18 (65 taps, alpha=0.35, 18 ksym @ 36 ksps)
  - band-edge FLL pair:  src/dsp/fll.cpp:61-95 (GNU-Radio-derived synthesis:
    sum of two sincs, spun up/down by (1+alpha) half-symbol rates)
  - Nuttall windowed-sinc polyphase interpolator: src/dsp/complex_fd.cpp:153-158
    (128 phases x 8 taps)

Taps are returned in natural convolution order: y[n] = sum_m h[m] x[n-m].
(The reference stores taps reversed and dot-products forward windows, which is
the same arithmetic up to a one-sample delay; see SURVEY.md section 2.2.)
"""

from __future__ import annotations

import numpy as np


def sinc(x: np.ndarray | float) -> np.ndarray | float:
    """sin(pi x)/(pi x) with sinc(0)=1 (normalized sinc)."""
    return np.sinc(x)


def root_raised_cosine(count: int, beta: float, symbol_rate: float,
                       sample_rate: float) -> np.ndarray:
    """Textbook RRC impulse response, unit DC gain, float32.

    h(t) with t in symbol periods, taps at t = (k - (count-1)/2) / sps.
    Singularities at t=0 and |t| = 1/(4 beta) use the analytic limits.
    """
    sps = sample_rate / symbol_rate
    t = (np.arange(count) - (count - 1) / 2.0) / sps
    h = np.empty(count, np.float64)
    eps = 1e-9
    t0 = np.abs(t) < eps
    ts = np.abs(np.abs(t) - 1.0 / (4.0 * beta)) < eps
    reg = ~(t0 | ts)
    tr = t[reg]
    h[reg] = (np.sin(np.pi * tr * (1 - beta))
              + 4 * beta * tr * np.cos(np.pi * tr * (1 + beta))) / (
        np.pi * tr * (1 - (4 * beta * tr) ** 2))
    h[t0] = 1.0 - beta + 4.0 * beta / np.pi
    h[ts] = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    h /= h.sum()
    return h.astype(np.float32)


def band_edge_pair(filt_size: int, alpha: float, symbol_rate: float,
                   sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
    """Low/high band-edge complex FIR kernels for the FLL.

    Baseband prototype: bb[i] = sinc(alpha k - 1/2) + sinc(alpha k + 1/2) with
    k = -M + 2 i / sps, M = floor(filt_size / sps); normalized by sum(bb).
    Spun by exp(-/+ j 2 pi (1+alpha) (i - N)/(2 sps)).  Returns (low, high)
    kernels in natural convolution order, complex64.
    """
    sps = sample_rate / symbol_rate
    M = int(filt_size / sps)
    i = np.arange(filt_size)
    k = -M + i * 2.0 / sps
    bb = sinc(alpha * k - 0.5) + sinc(alpha * k + 0.5)
    bb = bb / bb.sum()
    N = int((filt_size - 1) / 2)
    kk = (-N + i) / (2.0 * sps)
    spin = 2.0 * np.pi * (1.0 + alpha) * kk
    low = bb * np.exp(-1j * spin)
    high = bb * np.exp(1j * spin)
    # Returned in natural order: used as convolution kernels
    # y[n] = sum_m h[m] x[n-m], which reproduces the reference's
    # store-reversed-then-correlate arithmetic exactly (fll.cpp:88-93 +
    # SDR++ FIR dot product).  NOTE: time-reversing a complex kernel would
    # mirror its frequency response and swap the band edges (FLL sign flip).
    return low.astype(np.complex64), high.astype(np.complex64)


def nuttall(n: np.ndarray, N: int) -> np.ndarray:
    """Nuttall window (continuous-first-derivative variant)."""
    x = 2.0 * np.pi * n / (N - 1)
    return (0.355768 - 0.487396 * np.cos(x) + 0.144232 * np.cos(2 * x)
            - 0.012604 * np.cos(3 * x))


def interp_bank(phase_count: int = 128, taps_per_phase: int = 8) -> np.ndarray:
    """Polyphase fractional-delay interpolator bank, shape (P, T) float32.

    Nuttall-windowed sinc lowpass of length P*T with cutoff 0.5/P cycles per
    (oversampled) sample, decomposed so that bank[p] applied as
    y = sum_k bank[p, k] * x[offset + k] interpolates x at time
    offset + (T/2 - 1) + (p + eps)/P: phase index increases with fractional
    delay, matching the mu convention of the reference timing loop
    (complex_fd.cpp:101,126).
    """
    n_total = phase_count * taps_per_phase
    n = np.arange(n_total)
    c = (n_total - 1) / 2.0
    cutoff = 0.5 / phase_count  # cycles/sample in the oversampled domain
    lp = 2 * cutoff * np.sinc(2 * cutoff * (n - c)) * nuttall(n, n_total)
    bank = np.empty((phase_count, taps_per_phase), np.float64)
    for p in range(phase_count):
        # reversed stride-P slice: interpolation position grows with p
        bank[p] = phase_count * lp[p::phase_count][::-1]
    return bank.astype(np.float32)
