"""Feedforward block receiver: estimate-then-apply, no per-chunk feedback
(port of tetra_tpu/rx/demod_ff.py, mode="ff").

Every stage is a batched op or reduction over (C, T); there is no
sequential chain:

  AGC                block-mean gain (carried squelch for dead air)
  coarse CFO         one-shot z^4 estimate per block (range +-2.25 kHz),
                     carried snap-vs-smooth, continuous-phase derotation
  RRC                stateless matched filter (overlap-save)
  timing             2 -> 4 sps by one half-sample interpolation pass;
                     Oerder-Meyr tau per SEG_SYM-symbol segment, unwrapped
                     across segments by a cumsum, per-symbol tau by one
                     static interpolation matrix, integer-symbol alignment
                     chosen for cross-block continuity
  interpolation      one batched fractional-delay pass at the known
                     positions (demod_fast's LS Horner interpolator), each
                     symbol's 8-tap window gathered at its clipped offset
  carrier            three-tier residual frequency (lag-1, lag-8,
                     segment-lag), then per-segment Viterbi&Viterbi phase
                     with predicted-increment unwrap and extrapolated edges
  slicing            the quadrant/differential/remap rules of the other
                     chains, prev-symbol difference as a global shift

The reference shapes some of these around its TPU backend (a six-variant
shifted-slice loop in place of the window gather, a matmul for the
per-segment alternating sums); the port computes the same values directly.
Everything on the device is explicit (re, im) float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from ..core.fir import fir_stream_pair_mm
from . import demod_fast as DF
from .demod import _DIFF_REMAP, _tables, _to_pair

SEG_SYM = 256          # symbols per timing/phase estimation segment


class FfDemodState(NamedTuple):
    agc_gain: torch.Tensor
    rot_phase: torch.Tensor    # (C,) derotation phase anchor (rad)
    rot_freq: torch.Tensor     # (C,) derotation frequency (rad/sample)
    rrc_tail_re: torch.Tensor
    rrc_tail_im: torch.Tensor
    # the interpolation tail keeps 2 samples beyond the filter history so
    # block-head positions may reach p = -1 and still index the window
    mm_tail_re: torch.Tensor   # (C, INTERP_TAP_COUNT+1)
    mm_tail_im: torch.Tensor
    pos: torch.Tensor          # (C,) next-symbol position in block samples
    tau_anchor: torch.Tensor   # (C,) last unwrapped timing (symbol fraction)
    phi_anchor: torch.Tensor   # (C,) last unwrapped V&V phase (rad)
    cfo: torch.Tensor          # (C,) residual-CFO estimate (rad/symbol)
    ph2: torch.Tensor          # (C,) cumulative -pi/4 anchor (mod 2 pi)
    prev_sym: torch.Tensor     # (C,) i32 last quadrant


def demod_init(channels: int, device=None) -> FfDemodState:
    """Cold state for `channels` channels on `device` (the current CUDA
    device unless the caller asks for the CPU)."""
    C = channels
    device = resolve_device(device)
    zf = lambda: torch.zeros(C, dtype=torch.float32, device=device)
    z2 = lambda n: torch.zeros(C, n, dtype=torch.float32, device=device)
    return FfDemodState(
        agc_gain=torch.ones(C, dtype=torch.float32, device=device),
        rot_phase=zf(), rot_freq=zf(),
        rrc_tail_re=z2(P.RRC_TAP_COUNT - 1),
        rrc_tail_im=z2(P.RRC_TAP_COUNT - 1),
        mm_tail_re=z2(P.INTERP_TAP_COUNT + 1),
        mm_tail_im=z2(P.INTERP_TAP_COUNT + 1),
        pos=zf(), tau_anchor=zf(), phi_anchor=zf(), cfo=zf(), ph2=zf(),
        prev_sym=torch.zeros(C, dtype=torch.int32, device=device))


_HALF_TAPS = None


def _half_sample_taps() -> np.ndarray:
    """mu = 0.5 row of the LS fractional-delay interpolator (demod_fast
    _bank_polys): the one extra filter that upsamples 2 -> 4 sps."""
    global _HALF_TAPS
    if _HALF_TAPS is None:
        Pb, _ = DF._bank_polys()
        mus = np.array([0.5 ** p for p in range(5, -1, -1)], np.float32)
        _HALF_TAPS = (mus @ Pb).astype(np.float32)
    return _HALF_TAPS


def _interp_matrix(n_sym: int, n_seg: int) -> np.ndarray:
    """(n_seg, n_sym) static linear-interpolation weights from segment
    centers to per-symbol values (edge-clamped)."""
    centers = (np.arange(n_seg) + 0.5) * SEG_SYM
    k = np.arange(n_sym, dtype=np.float64)
    W = np.zeros((n_seg, n_sym), np.float32)
    x = np.clip((k - centers[0]) / SEG_SYM, 0.0, n_seg - 1.0)
    i0 = np.minimum(x.astype(np.int64), n_seg - 2) if n_seg > 1 else \
        np.zeros(n_sym, np.int64)
    frac = x - i0
    W[i0, np.arange(n_sym)] = (1.0 - frac).astype(np.float32)
    if n_seg > 1:
        W[i0 + 1, np.arange(n_sym)] += frac.astype(np.float32)
    return W


def _om_sums(g2, h2, n_seg: int):
    """Per-segment alternating-sign sums: om_re[:, s] = sum over segment s
    of g2 (+ on even samples, - on odd), om_im[:, s] the same of h2 with
    the signs swapped (the reference multiplies by a (T, 2 n_seg) matrix
    of these signs, _om_matrix)."""
    C, T = g2.shape
    g = g2.reshape(C, n_seg, T // n_seg // 2, 2)
    h = h2.reshape(C, n_seg, T // n_seg // 2, 2)
    return ((g[..., 0] - g[..., 1]).sum(2), (h[..., 1] - h[..., 0]).sum(2))


def _wrap(x, period):
    return x - period * torch.floor(x / period + 0.5)


def _demod_block_impl(state: FfDemodState, xr, xi):
    C, T = xr.shape
    if T % (2 * SEG_SYM):
        raise ValueError(f"block length {T} must hold whole segments "
                         f"(a multiple of {2 * SEG_SYM})")
    dev = xr.device
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    rrc, _, _ = _tables()

    # ---- stage 1: block AGC + z^4 coarse CFO derotation + RRC ----
    amp_mean = torch.sqrt(torch.clamp((xr * xr + xi * xi).mean(dim=1),
                                      min=1e-18))
    g_new = torch.clamp(P.AGC_SETPOINT / amp_mean, 1.0 / P.AGC_MAX_GAIN,
                        P.AGC_MAX_GAIN)
    # dead-air squelch as in the chunked AGC: hold gain over signal gaps
    gain = torch.where(amp_mean < 0.01 * P.AGC_SETPOINT, state.agc_gain,
                       g_new)
    yr = xr * gain[:, None]
    yi = xi * gain[:, None]

    # z = x[n] conj(x[n-2]) spans one symbol at 2 sps; z^4 collapses the
    # modulation to a tone at angle 8 w + pi, over the first quarter block
    Tq = max(T // 4, 512)
    qr = yr[:, :Tq]
    qi = yi[:, :Tq]
    dzr = qr[:, 2:] * qr[:, :-2] + qi[:, 2:] * qi[:, :-2]
    dzi = qi[:, 2:] * qr[:, :-2] - qr[:, 2:] * qi[:, :-2]
    z2r = dzr * dzr - dzi * dzi
    z2i = 2.0 * dzr * dzi
    z4r = (z2r * z2r - z2i * z2i).mean(dim=1)
    z4i = (2.0 * z2r * z2i).mean(dim=1)
    w_est = _wrap(torch.atan2(z4i, z4r) - np.pi, 2 * np.pi) / 8.0
    # carried frequency, snap-vs-smooth: big disagreements adopt the fresh
    # estimate, small ones low-pass it
    dw = w_est - state.rot_freq
    big = dw.abs() > (2 * np.pi * 40.0 / P.SAMPLE_RATE)
    w = torch.where(big, w_est, state.rot_freq + 0.25 * dw)
    rot_phase = torch.where(big, torch.zeros_like(w), state.rot_phase)
    # derotate by e^{-j(phase + w n)} (rotator recurrence, no per-sample
    # transcendentals)
    cr, sr0 = DF.rot_ramp_outer(rot_phase, w, T)
    rotr = yr * cr + yi * sr0
    roti = yi * cr - yr * sr0
    rot_phase_next = torch.remainder(rot_phase + w * T, 2 * np.pi)
    mfr, mfi, rtr, rti = fir_stream_pair_mm(
        rotr, roti, f32(rrc), state.rrc_tail_re, state.rrc_tail_im)

    ntaps = P.INTERP_TAP_COUNT
    er = torch.cat([state.mm_tail_re, mfr], dim=1)  # (C, T+ntaps+1)
    ei = torch.cat([state.mm_tail_im, mfi], dim=1)

    # ---- timing: 4 sps square-law + per-segment Oerder-Meyr ----
    # x4[2n] = ext[n + D] (on grid, delayed by the half taps' group delay
    # D), x4[2n + 1] = half(ext)[n]
    h = _half_sample_taps()
    D = ntaps // 2 - 1
    hr_ = float(h[0]) * er[:, 2:2 + T]
    hi_ = float(h[0]) * ei[:, 2:2 + T]
    for j in range(1, ntaps):
        hr_ = hr_ + float(h[j]) * er[:, 2 + j:2 + j + T]
        hi_ = hi_ + float(h[j]) * ei[:, 2 + j:2 + j + T]
    gr = er[:, 2 + D:2 + D + T]
    gi = ei[:, 2 + D:2 + D + T]
    g2 = gr * gr + gi * gi
    h2 = hr_ * hr_ + hi_ * hi_
    n_seg = T // (2 * SEG_SYM)
    om_re, om_im = _om_sums(g2, h2, n_seg)
    tau = -torch.atan2(om_im, om_re) / (2.0 * np.pi)         # symbol frac

    # unwrap across segments from the carried anchor (parallel cumsum)
    t0 = state.tau_anchor[:, None]
    d = torch.cat([_wrap(tau[:, :1] - t0, 1.0),
                   _wrap(tau[:, 1:] - tau[:, :-1], 1.0)], dim=1)
    tau_unw = t0 + torch.cumsum(d, dim=1)                     # (C, n_seg)
    tau_last = tau_unw[:, -1]

    # ---- per-symbol positions ----
    n_sym = T // 2 + 4
    tau_k = tau_unw @ f32(_interp_matrix(n_sym, n_seg))       # (C, n_sym)
    kk = torch.arange(n_sym, dtype=torch.float32, device=dev)
    # integer-symbol alignment for continuity with the carried position
    m = torch.round((state.pos - 2.0 * tau_k[:, 0]) / 2.0)
    p = 2.0 * kk[None, :] + 2.0 * tau_k + 2.0 * m[:, None]    # (C, n_sym)

    # ---- batched fractional-delay interpolation at known positions ----
    ipos = torch.floor(p).to(torch.int32)
    mu = p - torch.floor(p)
    valid = ipos < T
    Pb = f32(DF._bank_polys()[0])
    mu1 = mu[..., None]
    c0 = Pb[0] * mu1 + Pb[1]
    for j in range(2, 6):
        c0 = c0 * mu1 + Pb[j]                                 # (C, n_sym, 8)
    # window offsets j_off = floor(p_k) - 2k lie in [jmin, jmax]: +-1
    # symbol of block-head alignment plus in-block clock drift (E covers
    # +-250 ppm); each symbol's window starts at its clipped offset in the
    # stream front-padded by E
    E = int(np.ceil(n_sym * 2.5e-4)) if n_sym > 4096 else 0
    jmin, jmax = -2 - E, 3 + E
    pad = 2 * n_sym + jmax + 2 + ntaps - (T + ntaps + 1)
    ep = torch.nn.functional.pad(torch.stack([er, ei], dim=1),
                                 (E, max(pad, 0)))            # (C, 2, L)
    k2 = 2 * torch.arange(n_sym, dtype=torch.int32, device=dev)
    j_off = torch.clamp(ipos - k2[None, :], jmin, jmax)
    start = (j_off - jmin + k2[None, :]).long()               # (C, n_sym)
    idx = start[..., None] + torch.arange(ntaps, device=dev)  # (C, n_sym, 8)
    win = torch.gather(ep, 2, idx.reshape(C, 1, -1).expand(C, 2, -1)
                       ).reshape(C, 2, n_sym, ntaps)
    yr = c0[..., 0] * win[:, 0, :, 0]
    yi = c0[..., 0] * win[:, 1, :, 0]
    for t in range(1, ntaps):
        yr = yr + c0[..., t] * win[:, 0, :, t]
        yi = yi + c0[..., t] * win[:, 1, :, t]

    # ---- de-pi/4 (rotator ramp anchored by the carried ph2) ----
    cr, sr_neg = DF.rot_ramp(-state.ph2,
                             torch.full_like(state.ph2, np.pi / 4.0), n_sym,
                             time_first=False)
    # rot_ramp gives cos/sin of (-ph2 + pi/4 k); e^{j(ph2 - pi/4 k)} is its
    # conjugate
    sr_ = -sr_neg
    ypr = yr * cr - yi * sr_
    ypi = yi * cr + yr * sr_

    # ---- feedforward carrier recovery: frequency, then phase ----
    # normalized 4th power z = y'^4 / |y'|^2: angle(z) = pi + 4 phi
    y2r = ypr * ypr - ypi * ypi
    y2i = 2.0 * ypr * ypi
    mag2 = torch.clamp(ypr * ypr + ypi * ypi, min=1e-12)
    zr = (y2r * y2r - y2i * y2i) / mag2
    zi = (2.0 * y2r * y2i) / mag2
    vm = valid.to(torch.float32)
    zr = zr * vm
    zi = zi * vm

    # residual CFO in three tiers: lag-1 coarse (+-562 Hz), snapped against
    # the carried estimate; lag-8 (+-70 Hz); lag-one-segment refinement
    wr = (zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1]).sum(dim=1)
    wi = (zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1]).sum(dim=1)
    coarse = torch.atan2(wi, wr) / 4.0                        # rad/symbol
    snap = (coarse - state.cfo).abs() > (2 * np.pi * 40.0 / 18000.0)
    base = torch.where(snap, coarse, state.cfo)

    c4, s4 = DF.rot_ramp(torch.zeros_like(base), 4.0 * base, n_sym,
                         time_first=False)
    zfr = zr * c4 + zi * s4
    zfi = zi * c4 - zr * s4
    L8 = 8
    v8r = (zfr[:, L8:] * zfr[:, :-L8] + zfi[:, L8:] * zfi[:, :-L8]).sum(1)
    v8i = (zfi[:, L8:] * zfr[:, :-L8] - zfr[:, L8:] * zfi[:, :-L8]).sum(1)
    r8 = torch.atan2(v8i, v8r) / (4.0 * L8)
    base = base + r8
    c8, s8 = DF.rot_ramp(torch.zeros_like(r8), 4.0 * r8, n_sym,
                         time_first=False)
    zfr, zfi = zfr * c8 + zfi * s8, zfi * c8 - zfr * s8
    n_segp = n_sym // SEG_SYM                        # trailing <SEG ignored
    segr = zfr[:, :n_segp * SEG_SYM].reshape(C, n_segp, SEG_SYM).sum(2)
    segi = zfi[:, :n_segp * SEG_SYM].reshape(C, n_segp, SEG_SYM).sum(2)
    rr = (segr[:, 1:] * segr[:, :-1] + segi[:, 1:] * segi[:, :-1]).sum(1)
    ri = (segi[:, 1:] * segr[:, :-1] - segr[:, 1:] * segi[:, :-1]).sum(1)
    resid = torch.atan2(ri, rr) / (4.0 * SEG_SYM)
    domega = base + resid
    # rotate the segment sums by the refined residual at their centers
    cs = (torch.arange(n_segp, dtype=torch.float32, device=dev) + 0.5) \
        * SEG_SYM
    angr = 4.0 * resid[:, None] * cs[None, :]
    crr = torch.cos(angr)
    srr = torch.sin(angr)
    seg2r = segr * crr + segi * srr
    seg2i = segi * crr - segr * srr
    phi_f = (torch.atan2(seg2i, seg2r) - np.pi) / 4.0
    theta = phi_f + domega[:, None] * cs[None, :]
    # predicted-increment unwrap: wrap the deviation from the known ramp
    half_pi = np.pi / 2.0
    p0 = state.phi_anchor[:, None]
    pred0 = domega[:, None] * cs[None, :1]
    preds = domega[:, None] * SEG_SYM
    d0 = _wrap(theta[:, :1] - p0 - pred0, half_pi) + pred0
    ds = _wrap(theta[:, 1:] - theta[:, :-1] - preds, half_pi) + preds
    theta_unw = p0 + torch.cumsum(torch.cat([d0, ds], dim=1), dim=1)
    phi_k = theta_unw @ f32(_interp_matrix(n_sym, n_segp))
    # extend the edges clamped by the interpolation along the refined
    # frequency
    edge = (torch.clamp(kk - cs[0], max=0.0)[None, :]
            + torch.clamp(kk - cs[-1], min=0.0)[None, :])
    phi_k = phi_k + domega[:, None] * edge
    cp = torch.cos(phi_k)
    sp = torch.sin(phi_k)
    sr = ypr * cp + ypi * sp
    si = ypi * cp - ypr * sp

    # ---- quadrant slicing + differential decode (global shift) ----
    a = (si < 0).to(torch.int32)
    b = (sr < 0).to(torch.int32)
    quad = (a << 1) | (a ^ b)
    prev = torch.cat([state.prev_sym[:, None], quad[:, :-1]], dim=1)
    dibit = torch.from_numpy(_DIFF_REMAP).to(dev)[
        ((quad - prev) & 3).long()].to(torch.uint8)
    ab, bb = a.bool(), b.bool()
    ideal_ang = torch.where(ab, torch.where(bb, -3 * np.pi / 4, -np.pi / 4),
                            torch.where(bb, 3 * np.pi / 4, np.pi / 4))
    dist = torch.abs(ideal_ang - torch.atan2(si, sr))

    # ---- state carries ----
    n_valid = valid.sum(dim=1)
    last_q = torch.where(
        n_valid > 0,
        torch.gather(quad, 1, torch.clamp(n_valid - 1, min=0)[:, None])[:, 0],
        state.prev_sym)
    pos_next = torch.gather(
        p, 1, torch.clamp(n_valid, max=n_sym - 1)[:, None])[:, 0] - T
    ph2_next = torch.remainder(
        state.ph2 - (np.pi / 4.0) * n_valid.to(torch.float32), 2 * np.pi)
    # carrier-phase anchor at the next block's first symbol
    phi_end = theta_unw[:, -1] + domega * (
        n_valid.to(torch.float32) - cs[-1])

    new_state = FfDemodState(
        agc_gain=gain, rot_phase=rot_phase_next, rot_freq=w,
        rrc_tail_re=rtr, rrc_tail_im=rti,
        mm_tail_re=er[:, T:], mm_tail_im=ei[:, T:],  # last ntaps+1 columns
        pos=pos_next, tau_anchor=_wrap(tau_last, 1.0),
        phi_anchor=_wrap(phi_end, 2 * np.pi), cfo=domega,
        ph2=ph2_next, prev_sym=last_q.to(torch.int32))
    outs = dict(sym_re=sr, sym_im=si, dibits=dibit, valid=valid, dist=dist,
                fll_freq=w, agc_gain=gain)
    return new_state, outs


def demod_block(state: FfDemodState, iq: np.ndarray):
    """Feedforward demod of one (C, T) complex block on the state's
    device; T must be a multiple of 2*SEG_SYM."""
    iq = np.atleast_2d(iq)
    xr, xi = _to_pair(iq, state.agc_gain.device)
    return _demod_block_impl(state, xr, xi)


def demod_blocks(state: FfDemodState, iq: np.ndarray):
    """(k, C, T) stacked blocks demodulated in order (the reference's
    lax.scan as a loop); outputs gain a leading k axis."""
    iq = np.asarray(iq)
    if iq.ndim != 3:
        raise ValueError(f"expected (k, C, T) blocks, got {iq.shape}")
    xr, xi = _to_pair(iq, state.agc_gain.device)
    outs = []
    for j in range(iq.shape[0]):
        state, o = _demod_block_impl(state, xr[j], xi[j])
        outs.append(o)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
