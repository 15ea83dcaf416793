"""The least work of the front end and demod kernels, counted by shape,
and the card's peaks: the yardstick of the roofline metrics.

Copied from the program's chip check (k1_work, k2_work lean, k3_work)
with its constants frozen as numbers.  Each input byte is read once and
each output byte written once; operations are the algorithm's, not what
a kernel happens to execute.  A roofline share is the bound below over
the device time of the work, so a kernel that is replaced, split or
fused is still held to the same work.
"""

from __future__ import annotations

import math

# published peaks of one NVIDIA H100 SXM at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4

# the port's constants, frozen
RRC_HIST = 64           # matched-filter history (65 taps)
FLL_TAPS_KD = 32        # decimated band-edge taps per 64-sample chunk
K_SAMP = 64             # demod stage-1 chunk (samples)
K_SYM = 32              # demod stage-2 chunk (symbol slots)
OMEGA_MIN = 1.96        # slowest admissible samples per symbol
TAPS_PER_BRANCH = 48    # filterbank taps per branch
RS_TAPS = 24            # resampler taps per phase


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the FP32 rate, whichever is larger."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return dict(bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def symbol_slots(t36: int) -> int:
    """Stage-2 symbol slots of a t36-sample block: enough K_SYM chunks for
    the slowest clock, plus one, rounded up to even."""
    n = int(math.ceil(t36 / (K_SYM * OMEGA_MIN))) + 1
    return (n + (n & 1)) * K_SYM


def k1_work(T: int, C: int, Kd: int = FLL_TAPS_KD) -> dict:
    """K1 per (sample, channel): gain 2, |y| and its sum 5, rotator ramp
    24, derotation 6, RRC 2 x 65 FMAs (4 x 65 ops), band edge on Kd of
    every 64 samples 8 x 65 FMAs."""
    ntap = RRC_HIST + 1
    per = 2 + 5 + 24 + 6 + 4 * ntap + (Kd / K_SAMP) * 16 * ntap
    n_bytes = F32 * (4 * T * C + 4 * RRC_HIST * C + 6 * C + 5 * ntap) + 4 * Kd
    return bound(n_bytes, per * T * C)


def k2_work(T: int, C: int, S: int) -> dict:
    """K2 lean per symbol slot: 8 taps x 2 degree-5 Horner (160), the
    8-tap value and derivative dots (64), timing error 4, rotator ramp
    24, derotation 6, Costas error 4, |sin| dist 9; dibits, valid and
    dist out."""
    per = 160 + 64 + 4 + 24 + 6 + 4 + 9
    n_bytes = F32 * (2 * T * C + 2 * 7 * C + 16 * C + 3 * S * C + 96)
    return bound(n_bytes, per * S * C)


def k3_work(rows: int, n_ch: int, t36: int,
            n_s: int = 2 * TAPS_PER_BRANCH) -> dict:
    """K3 = the fold (n_ch branches x n_s/2 taps x 2 FMAs a frame), a
    length-n_ch complex FFT (5 n_ch log2 n_ch), the flip, then the 24-tap
    18/25 resample (2 x 24 FMAs an output).  Bytes: the hop-reshaped air,
    fold weights, resample taps and offsets and history in, the 36 kHz
    rows and history out."""
    n_out = rows - (n_s - 1)
    hop = n_ch // 2
    fft = 5 * n_ch * int(math.log2(n_ch))
    ops = n_out * (n_ch * (n_s // 2) * 4 + fft + 2 * n_ch) \
        + t36 * n_ch * 2 * 2 * RS_TAPS
    n_bytes = F32 * (2 * rows * hop + n_s * hop + 18 * RS_TAPS + 18
                     + 4 * (RS_TAPS - 1) * n_ch + 2 * t36 * n_ch)
    return bound(n_bytes, ops)


def frontend_ms(n_ch: int, t50: int, t36: int) -> float:
    """Bound of one block's front end (K3 on t50 + 95 hop rows)."""
    return k3_work(t50 + 2 * TAPS_PER_BRANCH - 1, n_ch, t36)["bound_ms"]


def demod_ms(n_ch: int, t36: int) -> float:
    """Bound of one block's demod: K1 and lean K2 together."""
    return (k1_work(t36, n_ch)["bound_ms"]
            + k2_work(t36, n_ch, symbol_slots(t36))["bound_ms"])
