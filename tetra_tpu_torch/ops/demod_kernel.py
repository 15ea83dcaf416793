"""K1: fused AGC + band-edge FLL + RRC matched filter (stage 1 of the demod).

Port of the TPU kernel tetra_tpu/ops/demod_pallas.py:agc_fll_rrc.  The CUDA
source is csrc/agc_fll_rrc.cu (its header says what bounds it on the card);
the plain PyTorch version is the reference twin _agc_fll_chunked +
fir_stream_pair.  Layout: time-major (T, C) float32, channels contiguous.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from ..core.fir import fir_stream_pair
from ..rx import demod_fast as DF
from ..rx.demod import _FLL_FREQ_LIM, _tables
from . import _build

HIST = P.RRC_TAP_COUNT - 1      # 64

@lru_cache(maxsize=None)
def _host_tables():
    """(5, 65) float32 taps [lo_r, lo_i, hi_r, hi_i, rrc] and the int32
    decimated band-edge tap offsets, in host memory: the launcher passes
    them to the kernel by value (its constant bank)."""
    rrc, be, _ = _tables()
    taps = np.ascontiguousarray(
        np.stack(list(be) + [np.asarray(rrc, np.float32)]), np.float32)
    offs = np.ascontiguousarray(DF._fll_tap_offsets(DF.K_SAMP), np.int32)
    return taps, offs


def agc_fll_rrc_plain(xr_t, xi_t, gain, phase, freq, hist_r, hist_i):
    """Plain PyTorch K1: x (T, C) pair, loop state (C,), rotated-sample
    history (64, C) -> matched filter (T, C) pair, final (gain, phase, freq)
    and the new (64, C) history."""
    rrc, be, _ = _tables()
    rotr, roti, g, p, f, hr, hi = DF._agc_fll_chunked(
        xr_t.T, xi_t.T, gain, phase, freq, hist_r.T, hist_i.T, be)
    h = torch.from_numpy(np.asarray(rrc, np.float32)).to(xr_t.device)
    mfr, mfi, _, _ = fir_stream_pair(rotr, roti, h, hist_r.T, hist_i.T)
    return (mfr.T.contiguous(), mfi.T.contiguous(), g, p, f,
            hr.T.contiguous(), hi.T.contiguous())


def _check(t: torch.Tensor, shape, name: str):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def agc_fll_rrc(xr_t, xi_t, gain, phase, freq, hist_r, hist_i):
    """K1 on CUDA tensors, its plain version on CPU tensors (same
    signature and outputs as agc_fll_rrc_plain)."""
    if xr_t.device.type == "cpu":
        return agc_fll_rrc_plain(xr_t, xi_t, gain, phase, freq, hist_r,
                                 hist_i)
    if xr_t.device.type != "cuda":
        raise ValueError(f"agc_fll_rrc: unsupported device {xr_t.device}")
    T, C = xr_t.shape
    if T % DF.K_SAMP:
        raise ValueError(f"agc_fll_rrc: T={T} not a multiple of "
                         f"{DF.K_SAMP}")
    for t, shp, nm in ((xr_t, (T, C), "xr"), (xi_t, (T, C), "xi"),
                       (gain, (C,), "gain"), (phase, (C,), "phase"),
                       (freq, (C,), "freq"), (hist_r, (HIST, C), "hist_r"),
                       (hist_i, (HIST, C), "hist_i")):
        _check(t, shp, nm)
    taps, offs = _host_tables()
    dev = xr_t.device
    mfr = torch.empty((T, C), dtype=torch.float32, device=dev)
    mfi = torch.empty_like(mfr)
    g_out = torch.empty((C,), dtype=torch.float32, device=dev)
    p_out = torch.empty_like(g_out)
    f_out = torch.empty_like(g_out)
    hr_out = torch.empty((HIST, C), dtype=torch.float32, device=dev)
    hi_out = torch.empty_like(hr_out)
    lib = _build.load()
    f32 = lambda v: float(np.float32(v))
    err = lib.launch_agc_fll_rrc(
        xr_t.data_ptr(), xi_t.data_ptr(), gain.data_ptr(), phase.data_ptr(),
        freq.data_ptr(), hist_r.data_ptr(), hist_i.data_ptr(),
        taps.ctypes.data, offs.ctypes.data, int(offs.size),
        mfr.data_ptr(), mfi.data_ptr(), g_out.data_ptr(), p_out.data_ptr(),
        f_out.data_ptr(), hr_out.data_ptr(), hi_out.data_ptr(),
        T, C,
        f32(1.0 - (1.0 - P.AGC_RATE) ** DF.K_SAMP), f32(P.AGC_SETPOINT),
        f32(0.01 * P.AGC_SETPOINT), f32(P.AGC_MAX_GAIN),
        f32(DF._FLL_BETA * DF.FLL_DECIM), f32(_FLL_FREQ_LIM),
        _build.stream_of(xr_t))
    _build.check(err, "agc_fll_rrc")
    agc_fll_rrc.launches += 1
    return mfr, mfi, g_out, p_out, f_out, hr_out, hi_out


agc_fll_rrc.launches = 0        # K1 kernel launches in this process
