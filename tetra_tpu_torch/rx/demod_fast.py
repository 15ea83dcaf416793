"""Production demod chain: chunked-update feedback loops (port of
tetra_tpu/rx/demod_fast.py).

Stage 1 (AGC + band-edge FLL + RRC matched filter) runs as the K1 kernel
(ops/demod_kernel.agc_fll_rrc) and stage 2 (ML timing + Costas + pi/4
differential slicer) as the K2 kernel (ops/mm_kernel.mm_costas); on CPU
tensors both wrappers run their plain PyTorch versions.  The loop gains,
grouping rules and update equations are the reference's; see that module
for how each constant was tuned.  All arithmetic is float32 (re, im) pairs.

Not ported (off by default in the reference): PAIR_STAGE1 and AGC_RMS.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from .demod import (_COSTAS_ALPHA as _COSTAS_ALPHA_REF,
                    _COSTAS_BETA as _COSTAS_BETA_REF,
                    _FLL_BETA as _FLL_BETA_REF,
                    _FLL_FREQ_LIM,
                    _MM_MU_GAIN as _MM_MU_GAIN_REF,
                    _MM_OMEGA_GAIN as _MM_OMEGA_GAIN_REF,
                    _OMEGA, _OMEGA_MAX, _OMEGA_MIN, _to_pair)

K_SAMP = 64    # AGC/FLL chunk length (samples)
K_SYM = 32     # timing/Costas chunk length (symbols)

_K_SAMP_REF = 64
_K_SYM_REF = 32
_FLL_BETA = _FLL_BETA_REF * float(np.sqrt(_K_SAMP_REF / K_SAMP))
_COSTAS_GAIN_SCALE = 0.5 * (_K_SYM_REF / K_SYM)
_COSTAS_ALPHA = _COSTAS_ALPHA_REF * _COSTAS_GAIN_SCALE
_COSTAS_BETA = _COSTAS_BETA_REF * _COSTAS_GAIN_SCALE
_MM_MU_GAIN = _MM_MU_GAIN_REF * 0.125 * (_K_SYM_REF / K_SYM)
_MM_OMEGA_GAIN = _MM_OMEGA_GAIN_REF * 0.0625 * (_K_SYM_REF / K_SYM) ** 2
_COSTAS_FREQ_LIM_CHUNKED = np.pi / (4.2 * K_SYM)

# pair-mode (two K_SYM chunks per stage-2 group) gain scales
_PAIR_MU = 0.5
_PAIR_OM = 0.25
_PAIR_CA = 0.7
_PAIR_CB = 0.5
_PAIR_CLIM = 0.5

# Band-edge error-tap decimation (the reference's TETRA_FLL_DECIM knob,
# read once at import): D must be 1 or an even divisor of K_SAMP, else the
# comb samples one cyclostationary phase only (a silent CRC-failure bias).
FLL_DECIM = int(os.environ.get("TETRA_FLL_DECIM", "2"))
if not (FLL_DECIM == 1 or (FLL_DECIM % 2 == 0
                            and K_SAMP % FLL_DECIM == 0)):
    raise ValueError(
        f"TETRA_FLL_DECIM={FLL_DECIM}: need 1 or an even divisor of "
        f"{K_SAMP}")


class FastDemodState(NamedTuple):
    agc_gain: torch.Tensor     # (C,)
    fll_phase: torch.Tensor    # (C,)
    fll_freq: torch.Tensor     # (C,)
    fll_hist_re: torch.Tensor  # (C, 64) rotated-sample history
    fll_hist_im: torch.Tensor
    rrc_tail_re: torch.Tensor  # (C, 64)
    rrc_tail_im: torch.Tensor
    mm_tail_re: torch.Tensor   # (C, 7)
    mm_tail_im: torch.Tensor
    mm_pos: torch.Tensor       # (C,) fractional sample position in block
    mm_omega: torch.Tensor     # (C,) samples/symbol
    cos_phase: torch.Tensor    # (C,)
    cos_freq: torch.Tensor     # (C,)
    cos_ph2: torch.Tensor      # (C,) cumulative -pi/4 (mod 2 pi)
    prev_sym: torch.Tensor     # (C,) int32


def demod_init(channels: int, device=None) -> FastDemodState:
    """Cold demod state for `channels` channels on `device` (the current
    CUDA device unless the caller asks for the CPU).  demod_block(s) run
    on the device of the state they are given."""
    C = channels
    device = resolve_device(device)
    zf = lambda: torch.zeros(C, dtype=torch.float32, device=device)
    z2 = lambda n: torch.zeros(C, n, dtype=torch.float32, device=device)
    return FastDemodState(
        agc_gain=torch.ones(C, dtype=torch.float32, device=device),
        fll_phase=zf(), fll_freq=zf(),
        fll_hist_re=z2(P.RRC_TAP_COUNT - 1),
        fll_hist_im=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_re=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_im=z2(P.RRC_TAP_COUNT - 1),
        mm_tail_re=z2(P.INTERP_TAP_COUNT - 1),
        mm_tail_im=z2(P.INTERP_TAP_COUNT - 1),
        mm_pos=zf(),
        mm_omega=torch.full((C,), _OMEGA, dtype=torch.float32,
                            device=device),
        cos_phase=zf(), cos_freq=zf(), cos_ph2=zf(),
        prev_sym=torch.zeros(C, dtype=torch.int32, device=device))


_POLY = None


def _bank_polys():
    """Degree-5 Horner-polynomial fractional-delay interpolator + derivative
    taps, (Pb, Pd) each (6, ntaps) float32, highest power first (the
    reference's least-squares design, computed by the same numpy code)."""
    global _POLY
    if _POLY is None:
        ntaps = P.INTERP_TAP_COUNT
        D = ntaps // 2 - 1
        fgrid = np.linspace(-0.36, 0.36, 481)
        E = np.exp(-2j * np.pi * np.outer(fgrid, np.arange(ntaps)))
        A = np.vstack([E.real, E.imag])
        mus = np.linspace(0.0, 1.0, 129)
        C = np.empty((len(mus), ntaps))
        Cd = np.empty((len(mus), ntaps))
        for i, mu in enumerate(mus):
            tgt = np.exp(-2j * np.pi * fgrid * (D + mu))
            C[i], *_ = np.linalg.lstsq(
                A, np.concatenate([tgt.real, tgt.imag]), rcond=None)
            tgtd = -2j * np.pi * fgrid * tgt
            Cd[i], *_ = np.linalg.lstsq(
                A, np.concatenate([tgtd.real, tgtd.imag]), rcond=None)
        V = np.vander(mus, 6)
        Pb, *_ = np.linalg.lstsq(V, C, rcond=None)
        Pd, *_ = np.linalg.lstsq(V, Cd, rcond=None)
        _POLY = (Pb.astype(np.float32), Pd.astype(np.float32))
    return _POLY


def n_chunks_for(block_len: int) -> int:
    """Stage-2 chunk count for a block: enough K_SYM chunks to cover it at
    the slowest admissible clock, rounded up to even (pair mode)."""
    n = int(np.ceil(block_len / (K_SYM * _OMEGA_MIN))) + 1
    return n + (n & 1)


def max_symbols(block_len: int) -> int:
    """Symbol slots of a block's demod output."""
    return n_chunks_for(block_len) * K_SYM


def _fll_tap_offsets(KG: int) -> np.ndarray:
    """Parity-balanced decimated band-edge tap positions in a KG-sample
    group."""
    D = FLL_DECIM
    if D == 1:
        return np.arange(KG)
    j = np.arange(KG // D)
    return D * j + D // 2 - 1 + (j & 1)


def _band_matrices(be, K: int = K_SAMP):
    """Banded convolution matrices H (M+K-1, K):
    y[k] = sum_j ext[j] H[j, k] = sum_m h[m] ext[k+M-1-m]."""
    M = P.RRC_TAP_COUNT
    rows = M + K - 1
    mats = []
    for h in be:
        H = np.zeros((rows, K), np.float32)
        for k in range(K):
            H[k:k + M, k] = h[::-1]
        mats.append(H)
    return mats


def rot_ramp(phase, freq, K: int, time_first: bool):
    """(cos, sin) of phase + freq*n for n = 0..K-1 by the rotator
    recurrence (two transcendental pairs per call, the powers e^{j freq n}
    by binary doubling; two-level for K a multiple of 64).  The K1/K2
    kernels evaluate the same recurrence per sample.
    phase/freq: (C,).  Returns (K, C) pairs if time_first else (C, K)."""
    chunk = 8
    if K % (chunk * chunk) == 0:
        Q = K // chunk
        cM, sM = rot_ramp(phase, freq * chunk, Q, time_first)
        cm, sm = rot_ramp(torch.zeros_like(phase), freq, chunk, time_first)
        ax = 0 if time_first else 1
        reps = (Q, 1) if time_first else (1, Q)
        cMr = cM.repeat_interleave(chunk, dim=ax)
        sMr = sM.repeat_interleave(chunk, dim=ax)
        cmr = cm.repeat(*reps)
        smr = sm.repeat(*reps)
        return cMr * cmr - sMr * smr, sMr * cmr + cMr * smr
    c = torch.cos(phase)
    s = torch.sin(phase)
    wc = torch.cos(freq)
    ws = torch.sin(freq)
    ns = torch.arange(K, device=phase.device, dtype=torch.int32)
    if time_first:
        c = c[None, :].expand(K, -1)
        s = s[None, :].expand(K, -1)
        ns = ns[:, None]
        wsel = lambda w: w[None, :]
    else:
        c = c[:, None].expand(-1, K)
        s = s[:, None].expand(-1, K)
        ns = ns[None, :]
        wsel = lambda w: w[:, None]
    for b in range(max(1, (K - 1).bit_length())):
        m = ((ns >> b) & 1) == 1
        wcb, wsb = wsel(wc), wsel(ws)
        cn = c * wcb - s * wsb
        sn = s * wcb + c * wsb
        c = torch.where(m, cn, c)
        s = torch.where(m, sn, s)
        wc, ws = wc * wc - ws * ws, 2.0 * wc * ws
    return c, s


def rot_ramp_outer(phase, freq, K: int, chunk: int = 64):
    """rot_ramp as a two-level outer product: e^{j(phase + freq n)} with
    n = chunk q + r as (major ramp over q) x (minor ramp over r); the
    doubling runs on (C, K/chunk) and (C, chunk) only.  Returns (C, K)
    cos/sin."""
    if K % chunk:
        raise ValueError(f"K={K} is not a multiple of chunk={chunk}")
    Q = K // chunk
    cM, sM = rot_ramp(phase, freq * chunk, Q, time_first=False)   # (C, Q)
    cm, sm = rot_ramp(torch.zeros_like(phase), freq, chunk,
                      time_first=False)                           # (C, chunk)
    c = cM[:, :, None] * cm[:, None, :] - sM[:, :, None] * sm[:, None, :]
    s = sM[:, :, None] * cm[:, None, :] + cM[:, :, None] * sm[:, None, :]
    C = phase.shape[0]
    return c.reshape(C, K), s.reshape(C, K)


def _agc_fll_chunked(xr, xi, gain, phase, freq, hre, him, be):
    """Chunked AGC/FLL, one loop update per K_SAMP-sample group (the plain
    form of K1's loop).  x: (C, T).  Returns the rotated stream (C, T) pair,
    the final (gain, phase, freq) and the (C, 64) rotated history."""
    C, T = xr.shape
    if T % K_SAMP:
        raise ValueError(f"block length {T} is not a multiple of {K_SAMP}")
    KG = K_SAMP
    M = P.RRC_TAP_COUNT
    D = FLL_DECIM
    offs = _fll_tap_offsets(KG)
    dev = xr.device
    Hlo_r, Hlo_i, Hhi_r, Hhi_i = [torch.from_numpy(H[:, offs].copy()).to(dev)
                                  for H in _band_matrices(be, KG)]
    r_eff = 1.0 - (1.0 - P.AGC_RATE) ** K_SAMP
    beta_d = _FLL_BETA * D
    fa = lambda re, im: torch.maximum(re.abs(), im.abs()) \
        + 0.4 * torch.minimum(re.abs(), im.abs())
    outr, outi = [], []
    for g in range(T // KG):
        sl = slice(g * KG, (g + 1) * KG)
        yr, yi = xr[:, sl] * gain[:, None], xi[:, sl] * gain[:, None]
        c, s = rot_ramp(phase, freq, KG, time_first=False)
        rr = yr * c + yi * s
        ri = yi * c - yr * s
        er = torch.cat([hre, rr], dim=1)          # (C, M-1+KG)
        ei = torch.cat([him, ri], dim=1)
        lo_re = er @ Hlo_r - ei @ Hlo_i
        lo_im = er @ Hlo_i + ei @ Hlo_r
        hi_re = er @ Hhi_r - ei @ Hhi_i
        hi_im = er @ Hhi_i + ei @ Hhi_r
        err = fa(hi_re, hi_im) - fa(lo_re, lo_im)          # (C, KG//D)
        ramp_freq = freq
        amp_mean = torch.sqrt(yr * yr + yi * yi).mean(dim=1)
        amp_mean = torch.clamp(amp_mean, min=1e-9)
        ratio = torch.clamp(P.AGC_SETPOINT / amp_mean, 0.25, 4.0)
        # dead-air squelch: hold the gain through an empty chunk
        ratio = torch.where(amp_mean < 0.01 * P.AGC_SETPOINT,
                            torch.ones_like(ratio), ratio)
        gain = torch.clamp(gain * ratio ** r_eff, max=P.AGC_MAX_GAIN)
        freq = torch.clamp(freq + beta_d * err.sum(dim=1),
                           -_FLL_FREQ_LIM, _FLL_FREQ_LIM)
        new_phase = phase + ramp_freq * KG
        phase = new_phase - 2 * np.pi * torch.floor(
            (new_phase + np.pi) / (2 * np.pi))
        hre, him = er[:, -(M - 1):], ei[:, -(M - 1):]
        outr.append(rr)
        outi.append(ri)
    return (torch.cat(outr, dim=1), torch.cat(outi, dim=1), gain, phase,
            freq, hre, him)


def _demod_block_impl(state: FastDemodState, xr, xi, n_chunks: int,
                      tc_out: bool = False):
    """One (C, T) block through K1 then K2.

    tc_out (the wideband superblock form): run K2 lean -- no sym_re/sym_im
    -- and return only the time-major (T, C) dibits_tc/valid_tc/dist_tc
    (int32, int32, f32) plus fll_freq/agc_gain.  Otherwise return the
    channel-major dibits (uint8), valid (bool), dist, sym_re, sym_im."""
    from ..ops.demod_kernel import agc_fll_rrc
    from ..ops.mm_kernel import mm_costas

    mfr_t, mfi_t, gain, fphase, ffreq, hr1, hi1 = agc_fll_rrc(
        xr.T.contiguous(), xi.T.contiguous(),
        state.agc_gain, state.fll_phase, state.fll_freq,
        state.fll_hist_re.T.contiguous(), state.fll_hist_im.T.contiguous())
    zero = torch.zeros_like(state.mm_pos)
    st0 = torch.stack([
        state.mm_pos, state.mm_omega, state.cos_phase, state.cos_freq,
        state.cos_ph2, state.prev_sym.to(torch.float32), zero, zero])
    lean = bool(tc_out)
    res = mm_costas(mfr_t, mfi_t, st0, n_chunks, emit_syms=not lean,
                    tail_re=state.mm_tail_re.T.contiguous(),
                    tail_im=state.mm_tail_im.T.contiguous())
    if lean:
        dib_t, val_t, dist_t, st_out = res
    else:
        sr_t, si_t, dib_t, val_t, dist_t, st_out = res
    T = mfr_t.shape[0]
    nt = P.INTERP_TAP_COUNT - 1
    new_state = FastDemodState(
        agc_gain=gain, fll_phase=fphase, fll_freq=ffreq,
        fll_hist_re=hr1.T, fll_hist_im=hi1.T,
        rrc_tail_re=hr1.T, rrc_tail_im=hi1.T,
        mm_tail_re=mfr_t[T - nt:].T, mm_tail_im=mfi_t[T - nt:].T,
        mm_pos=st_out[0], mm_omega=st_out[1], cos_phase=st_out[2],
        cos_freq=st_out[3], cos_ph2=st_out[4],
        prev_sym=st_out[5].to(torch.int32))
    outs = dict(fll_freq=ffreq, agc_gain=gain)
    if lean:
        outs.update(dibits_tc=dib_t, valid_tc=val_t, dist_tc=dist_t)
    else:
        outs.update(dibits=dib_t.T.to(torch.uint8), valid=val_t.T.bool(),
                    dist=dist_t.T, sym_re=sr_t.T, sym_im=si_t.T)
    return new_state, outs


def demod_block(state: FastDemodState, iq: np.ndarray):
    """Chunked-mode demod of one (C, T) complex block on the state's
    device.  T must be a multiple of K_SAMP."""
    iq = np.atleast_2d(iq)
    xr, xi = _to_pair(iq, state.agc_gain.device)
    return _demod_block_impl(state, xr, xi, n_chunks_for(iq.shape[1]))


def demod_blocks(state: FastDemodState, iq: np.ndarray):
    """(k, C, T) stacked blocks demodulated in order; state streams across
    blocks exactly as k demod_block calls.  Outputs gain a leading k axis."""
    iq = np.asarray(iq)
    if iq.ndim != 3:
        raise ValueError(f"expected (k, C, T) blocks, got {iq.shape}")
    n_chunks = n_chunks_for(iq.shape[2])
    xr, xi = _to_pair(iq, state.agc_gain.device)
    outs = []
    for j in range(iq.shape[0]):
        state, o = _demod_block_impl(state, xr[j], xi[j], n_chunks)
        outs.append(o)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
