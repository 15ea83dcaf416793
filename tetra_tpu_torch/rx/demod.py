"""pi/4-DQPSK per-sample demodulation chain, batched over channels (port of
tetra_tpu/rx/demod.py): mode="exact", the reference-parity oracle.

AGC -> band-edge FLL -> RRC -> ML timing recovery -> Costas -> symbol
extraction (the reference's src/dsp/pi4dqpsk.cpp:132-140, fll.cpp:135-149,
complex_fd.cpp:89-151, pi4dqpsk_costas.cpp:5-21, dqpsk_sym_extr.cpp:4-55)
as a pure function over (channels, time) blocks on (re, im) float32 pairs:

  * the AGC + FLL loop runs one step per sample (_agc_fll_scan), the RRC
    matched filter is a stateless overlap-save convolution, and timing
    recovery + Costas + the differential slicer run one step per output
    symbol slot (_mm_costas_scan) with a data-dependent stride into the
    block (a fixed slot count and a validity mask);
  * each step is a handful of torch ops over the channel axis on the
    state's device, in the reference's order: an explicit Python loop
    where the reference runs lax.scan.  It is the parity oracle, kept step
    by step (no chunking, no kernel); rx/demod_fast.py is the production
    chain;
  * block-to-block loop state is an explicit DemodState, so streaming is
    `state, outs = demod_block(state, iq)`.

The module also holds the tables and loop constants the chunked chain
(rx/demod_fast.py) and its kernels read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from ..core import taps as taps_mod
from ..core.fir import fir_stream_pair
from ..core.loops import critically_damped

_FLL_ALPHA, _FLL_BETA = critically_damped(P.FLL_LOOP_BANDWIDTH)
_FLL_ALPHA = 0.0  # FLL tracks frequency only (fll.cpp:25-26)
_COSTAS_ALPHA, _COSTAS_BETA = critically_damped(P.COSTAS_LOOP_BANDWIDTH)
_MM_MU_GAIN, _MM_OMEGA_GAIN = critically_damped(
    P.CLOCK_RECOVERY_BW, P.CLOCK_RECOVERY_DAMPING)

_OMEGA = 2.0  # samples per symbol
_OMEGA_MIN = _OMEGA * (1.0 - P.CLOCK_RECOVERY_REL_LIMIT)
_OMEGA_MAX = _OMEGA * (1.0 + P.CLOCK_RECOVERY_REL_LIMIT)
_FLL_FREQ_LIM = np.pi / 2.0
_COSTAS_FREQ_LIM = np.pi / 10.0

# quadrant sym = (im<0)<<1 | ((im<0)!=(re<0)); diff = (sym - prev) mod 4;
# the remap swaps 0b10/0b11 (dqpsk_sym_extr.cpp:33-52)
_DIFF_REMAP = np.array([0, 1, 3, 2], np.int32)

_TABLES = None


def _tables():
    """(rrc taps, (lo_r, lo_i, hi_r, hi_i) band-edge taps, interp bank):
    numpy float32, computed by the same host code as the reference."""
    global _TABLES
    if _TABLES is None:
        rrc = taps_mod.root_raised_cosine(
            P.RRC_TAP_COUNT, P.RRC_ALPHA, P.SYMBOL_RATE, P.SAMPLE_RATE)
        lo, hi = taps_mod.band_edge_pair(
            P.RRC_TAP_COUNT, P.RRC_ALPHA, P.SYMBOL_RATE, P.SAMPLE_RATE)
        be = (np.real(lo).astype(np.float32), np.imag(lo).astype(np.float32),
              np.real(hi).astype(np.float32), np.imag(hi).astype(np.float32))
        bank = taps_mod.interp_bank(P.INTERP_PHASE_COUNT, P.INTERP_TAP_COUNT)
        _TABLES = (rrc, be, bank)
    return _TABLES


def max_symbols(block_len: int) -> int:
    """Static output-slot count for a block of `block_len` samples."""
    return int(np.ceil(block_len / _OMEGA_MIN)) + 2


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class DemodState(NamedTuple):
    agc_gain: torch.Tensor     # (C,) f32
    fll_phase: torch.Tensor    # (C,) f32
    fll_freq: torch.Tensor     # (C,) f32
    fll_hist_re: torch.Tensor  # (C, RRC_TAP_COUNT-1) rotated-sample history
    fll_hist_im: torch.Tensor
    rrc_tail_re: torch.Tensor  # (C, RRC_TAP_COUNT-1)
    rrc_tail_im: torch.Tensor
    mm_tail_re: torch.Tensor   # (C, INTERP_TAP_COUNT-1)
    mm_tail_im: torch.Tensor
    mm_offset: torch.Tensor    # (C,) i32 read offset into the current block
    mm_mu: torch.Tensor        # (C,) f32 fractional sample phase in [0,1)
    mm_freq: torch.Tensor      # (C,) f32 samples/symbol estimate
    cos_phase: torch.Tensor    # (C,) f32
    cos_freq: torch.Tensor     # (C,) f32
    cos_ph2: torch.Tensor      # (C,) f32 cumulative -pi/4 derotation
    prev_sym: torch.Tensor     # (C,) i32 previous quadrant for diff decode


def demod_init(channels: int, device=None) -> DemodState:
    """Cold state for `channels` channels on `device` (the current CUDA
    device unless the caller asks for the CPU).  demod_block runs on the
    device of the state it is given."""
    C = channels
    device = resolve_device(device)
    zf = lambda: torch.zeros(C, dtype=torch.float32, device=device)
    z2 = lambda n: torch.zeros(C, n, dtype=torch.float32, device=device)
    zi = lambda: torch.zeros(C, dtype=torch.int32, device=device)
    return DemodState(
        agc_gain=torch.ones(C, dtype=torch.float32, device=device),
        fll_phase=zf(), fll_freq=zf(),
        fll_hist_re=z2(P.RRC_TAP_COUNT - 1),
        fll_hist_im=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_re=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_im=z2(P.RRC_TAP_COUNT - 1),
        mm_tail_re=z2(P.INTERP_TAP_COUNT - 1),
        mm_tail_im=z2(P.INTERP_TAP_COUNT - 1),
        mm_offset=zi(), mm_mu=zf(),
        mm_freq=torch.full((C,), _OMEGA, dtype=torch.float32, device=device),
        cos_phase=zf(), cos_freq=zf(), cos_ph2=zf(), prev_sym=zi())


# ---------------------------------------------------------------------------
# Stage 1: fused AGC + FLL, one step per sample
# ---------------------------------------------------------------------------


def _agc_fll_scan(xr, xi, gain, phase, freq, hist_re, hist_im, be):
    """x: (C, T) -> rotated, gain-normalized samples (C, T) + final state.

    Per sample (fll.cpp:135-149 + SDR++ FastAGC):
      y   = x * gain;            gain += rate * (setpoint - |y|)
      xr  = y * exp(-j phase)
      err = fastamp(FIR_high(xr)) - fastamp(FIR_low(xr))
      freq = clamp(freq + beta * err);  phase = wrap(phase + freq)
    with fastamp(z) = max(|re|, |im|) + 0.4 min(|re|, |im|) (SDR++
    complex_t::fastAmplitude).

    Each sample is an interleaved (re, im) pair.  The rotated samples go
    into one (C, M-1+T, 2) buffer behind the carried history, so each
    step's M-tap window is a (C, 2M) view of it and the four band-edge dot
    products (lo re/im, hi re/im) are one matrix product."""
    C, T = xr.shape
    M = P.RRC_TAP_COUNT
    dev = xr.device
    lo_r, lo_i, hi_r, hi_i = [np.ascontiguousarray(t[::-1]) for t in be]
    # rows 2m / 2m + 1: the taps a window sample's re / im part meets
    taps = np.empty((M, 2, 4), np.float32)
    taps[:, 0] = np.stack([lo_r, lo_i, hi_r, hi_i], axis=1)
    taps[:, 1] = np.stack([-lo_i, lo_r, -hi_i, hi_r], axis=1)
    taps = torch.from_numpy(taps.reshape(2 * M, 4)).to(dev)
    x = torch.stack([xr, xi], dim=2)                          # (C, T, 2)
    buf = torch.empty((C, M - 1 + T, 2), dtype=torch.float32, device=dev)
    buf[:, :M - 1, 0] = hist_re
    buf[:, :M - 1, 1] = hist_im
    conj = torch.tensor([1.0, -1.0], device=dev)
    for t in range(T):
        y = x[:, t] * gain[:, None]
        amp = torch.sqrt(y.square().sum(dim=1))
        gain = torch.clamp(gain + P.AGC_RATE * (P.AGC_SETPOINT - amp),
                           max=P.AGC_MAX_GAIN)
        # y e^{-j phase} = (yr c + yi s, yi c - yr s)
        buf[:, M - 1 + t] = y * torch.cos(phase)[:, None] \
            + y.flip(1) * (torch.sin(phase)[:, None] * conj)
        f = (buf[:, t:t + M].reshape(C, 2 * M) @ taps).view(C, 2, 2).abs()
        fa = f.amax(dim=2) + 0.4 * f.amin(dim=2)              # lo, hi
        freq = torch.clamp(freq + _FLL_BETA * (fa[:, 1] - fa[:, 0]),
                           -_FLL_FREQ_LIM, _FLL_FREQ_LIM)
        phase = phase + freq
        phase = phase - 2 * np.pi * torch.floor((phase + np.pi)
                                                / (2 * np.pi))
    return (buf[:, M - 1:, 0], buf[:, M - 1:, 1], gain, phase, freq,
            buf[:, T:, 0], buf[:, T:, 1])


# ---------------------------------------------------------------------------
# Stage 2: timing recovery + Costas + symbol extraction, one step per slot
# ---------------------------------------------------------------------------


def _mm_costas_scan(yr, yi, tail_re, tail_im, offset, mu, freq,
                    cphase, cfreq, ph2, prev_sym, bank, n_slots: int):
    """y: (C, T) matched-filter output.  Returns per-slot outputs + state.

    Timing (complex_fd.cpp:89-151): polyphase interpolate at phase
    floor(mu*128); ML error sign(re)*d re/dt + sign(im)*d im/dt from adjacent
    filter phases; 2nd-order loop on (mu, omega); stride floor(mu) samples.
    Costas (pi4dqpsk_costas.cpp): derotate by loop phase and cumulative
    -pi/4/symbol; QPSK decision error step(re)*im - step(im)*re.

    The interpolants' (re, im) pairs are computed together, as (C, 2)
    tensors, and the selects' constants are device tensors made once.
    """
    C, T = yr.shape
    dev = yr.device
    ext = torch.stack([torch.cat([tail_re, yr], dim=1),
                       torch.cat([tail_im, yi], dim=1)], dim=1)  # (C, 2, T+7)
    ntaps = P.INTERP_TAP_COUNT
    nph = P.INTERP_PHASE_COUNT
    k = torch.arange(ntaps, device=dev)
    # the interpolator phase, the next one and the previous one
    d3 = torch.tensor([0, 1, -1], device=dev)
    bank = torch.as_tensor(np.asarray(bank, np.float32)).to(dev)
    remap = torch.from_numpy(_DIFF_REMAP).to(dev)
    zero = torch.zeros(C, device=dev)
    pos1, pos2 = torch.ones(C, device=dev), torch.ones((C, 2), device=dev)
    neg1, neg2 = -pos1, -pos2
    # sign with sign(0) = -1, as the reference's where(v > 0, 1, -1)
    sgn1 = lambda v: torch.where(v > 0, pos1, neg1)
    ideal_p, ideal_n = 0.7071 * pos1, -0.7071 * pos1
    outs = {n: [] for n in ("sym_re", "sym_im", "dibits", "valid", "dist")}
    for _ in range(n_slots):
        valid = offset < T
        idx = torch.clamp(offset, 0, T - 1)[:, None] + k           # int64
        win = torch.gather(ext, 2, idx[:, None, :].expand(C, 2, ntaps))
        phase_i = torch.clamp((mu * nph).to(torch.int32), 0, nph - 1)
        rows = torch.clamp(phase_i[:, None] + d3, 0, nph - 1)
        # (C, 2 [re, im], 3 [phase_i, + 1, - 1])
        f = torch.bmm(win, bank[rows].transpose(1, 2))
        f0 = f[:, :, 0]
        d = torch.where((phase_i == 0)[:, None], f[:, :, 1] - f0,
                        torch.where((phase_i == nph - 1)[:, None],
                                    f0 - f[:, :, 2],
                                    (f[:, :, 1] - f[:, :, 2]) * 0.5))
        err = torch.clamp((torch.where(f0 > 0, pos2, neg2) * d).sum(dim=1),
                          -1.0, 1.0)
        err = torch.where(valid, err, zero)
        freq_n = torch.clamp(freq + _MM_OMEGA_GAIN * err, _OMEGA_MIN,
                             _OMEGA_MAX)
        mu_n = mu + freq_n + _MM_MU_GAIN * err
        delta = torch.floor(mu_n)
        offset_n = offset + delta.to(torch.int32)
        mu_n = mu_n - delta
        freq = torch.where(valid, freq_n, freq)
        mu = torch.where(valid, mu_n, mu)
        offset = torch.where(valid, offset_n, offset)

        # ---- Costas on the interpolated symbol ----
        ph2_n = ph2 - np.pi / 4.0
        ph2_n = torch.where(ph2_n <= -2 * np.pi, ph2_n + 2 * np.pi, ph2_n)
        ang = ph2_n - cphase      # combined rotation exp(j(ph2 - cphase))
        c, s = torch.cos(ang), torch.sin(ang)
        f0r, f0i = f0[:, 0], f0[:, 1]
        sr = f0r * c - f0i * s
        si = f0i * c + f0r * s
        cerr = torch.clamp(sgn1(sr) * si - sgn1(si) * sr, -1.0, 1.0)
        cerr = torch.where(valid, cerr, zero)
        cfreq_n = torch.clamp(cfreq + _COSTAS_BETA * cerr,
                              -_COSTAS_FREQ_LIM, _COSTAS_FREQ_LIM)
        cphase_n = cphase + cfreq_n + _COSTAS_ALPHA * cerr
        cphase_n = cphase_n - 2 * np.pi * torch.floor(
            (cphase_n + np.pi) / (2 * np.pi))
        cphase = torch.where(valid, cphase_n, cphase)
        cfreq = torch.where(valid, cfreq_n, cfreq)
        ph2 = torch.where(valid, ph2_n, ph2)

        # ---- differential symbol extraction ----
        a = si < 0
        b = sr < 0
        quad = (a.to(torch.int32) << 1) | (a != b).to(torch.int32)
        dibit = remap[(quad - prev_sym) & 3]
        prev_sym = torch.where(valid, quad, prev_sym)
        # phase distance to the ideal constellation point (quality gate)
        dist = torch.abs(torch.atan2(torch.where(a, ideal_n, ideal_p),
                                     torch.where(b, ideal_n, ideal_p))
                         - torch.atan2(si, sr))
        for n, v in zip(outs, (sr, si, dibit, valid, dist)):
            outs[n].append(v)
    outs = {n: torch.stack(v, dim=1) for n, v in outs.items()}
    outs["dibits"] = outs["dibits"].to(torch.uint8)
    return (outs, ext[:, 0, T:], ext[:, 1, T:], offset - T, mu, freq, cphase,
            cfreq, ph2, prev_sym)


# ---------------------------------------------------------------------------
# Full chain
# ---------------------------------------------------------------------------


def _demod_block_impl(state: DemodState, xr: torch.Tensor, xi: torch.Tensor,
                      n_slots: int):
    rrc, be, bank = _tables()
    (rotr, roti, gain, fphase, ffreq, fhre, fhim) = _agc_fll_scan(
        xr, xi, state.agc_gain, state.fll_phase, state.fll_freq,
        state.fll_hist_re, state.fll_hist_im, be)
    mfr, mfi, rtr, rti = fir_stream_pair(
        rotr, roti, torch.from_numpy(np.asarray(rrc, np.float32)).to(
            xr.device), state.rrc_tail_re, state.rrc_tail_im)
    (outs, mtr, mti, offset, mu, mfreq, cphase, cfreq, ph2, prev_sym) = (
        _mm_costas_scan(mfr, mfi, state.mm_tail_re, state.mm_tail_im,
                        state.mm_offset, state.mm_mu, state.mm_freq,
                        state.cos_phase, state.cos_freq, state.cos_ph2,
                        state.prev_sym, bank, n_slots))
    new_state = DemodState(
        agc_gain=gain, fll_phase=fphase, fll_freq=ffreq,
        fll_hist_re=fhre, fll_hist_im=fhim,
        rrc_tail_re=rtr, rrc_tail_im=rti,
        mm_tail_re=mtr, mm_tail_im=mti, mm_offset=offset, mm_mu=mu,
        mm_freq=mfreq, cos_phase=cphase, cos_freq=cfreq, cos_ph2=ph2,
        prev_sym=prev_sym)
    outs["fll_freq"] = ffreq
    outs["agc_gain"] = gain
    return new_state, outs


def _to_pair(iq: np.ndarray, device):
    """Complex numpy (..., T) -> float32 (re, im) tensors on `device`."""
    xr = torch.from_numpy(np.ascontiguousarray(iq.real, dtype=np.float32))
    xi = torch.from_numpy(np.ascontiguousarray(iq.imag, dtype=np.float32))
    return xr.to(device), xi.to(device)


def demod_block(state: DemodState, iq: np.ndarray):
    """Demodulate one (C, T) block of complex baseband on the state's
    device (complex at the host boundary only; split into float pairs
    before the device).

    Returns (new_state, outs) with outs:
      sym_re/sym_im (C, S) f32  post-Costas constellation points
      dibits (C, S) uint8  TETRA dibits (MSB-first bit pairs)
      valid  (C, S) bool   slot produced a symbol
      dist   (C, S) f32    |phase error| vs ideal constellation point
    """
    iq = np.atleast_2d(iq)
    xr, xi = _to_pair(iq, state.agc_gain.device)
    return _demod_block_impl(state, xr, xi, max_symbols(iq.shape[1]))


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """Unpack dibit stream to bits, MSB first (bit_unpacker.cpp:4-11)."""
    dibits = np.asarray(dibits, np.uint8)
    out = np.empty(dibits.shape[:-1] + (dibits.shape[-1] * 2,), np.uint8)
    out[..., 0::2] = (dibits >> 1) & 1
    out[..., 1::2] = dibits & 1
    return out
