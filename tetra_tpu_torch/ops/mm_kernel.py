"""K2: fused ML timing recovery + Costas + pi/4-DQPSK slicer (stage 2).

Port of the TPU kernel tetra_tpu/ops/mm_pallas.py:mm_costas.  The CUDA
source is csrc/mm_costas.cu; mm_costas_plain below is its plain PyTorch
version.  It follows the KERNEL's semantics, which differ from the
reference's XLA twin (_mm_costas_chunked) in two places that show in the
outputs: the time-major Costas ramp, and `dist` as the |sin| angle-error
proxy (the superblock's quality rows are built from it) instead of the
arctan2 angle.  `valid` is ipos < T: the TPU kernel additionally dropped
symbols whose channel sat >= 512 rows past its 128-lane tile's minimum (a
barrel-shifter limit), which a locked fleet never reaches (ROADMAP Queue 3).

Layout: time-major.  Inputs mf (T, C) float32 pair plus the (7, C) carried
tails and the (8, C) state rows [pos, omega, cphase, cfreq, ph2, prev_sym,
0, 0]; outputs (n_chunks*K_SYM, C) dibits/valid int32 and dist float32,
sym_re/sym_im unless emit_syms=False, and the final (8, C) state.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from ..rx import demod_fast as DF
from ..rx.demod import _DIFF_REMAP
from . import _build

NTAPS = P.INTERP_TAP_COUNT            # 8

_f32 = lambda v: float(np.float32(v))
PI4 = _f32(np.pi / 4.0)
TWO_PI = _f32(2 * np.pi)
PI = _f32(np.pi)


def _gains(pair: bool) -> dict:
    clim = _f32(DF._COSTAS_FREQ_LIM_CHUNKED * (DF._PAIR_CLIM if pair else 1.0))
    return dict(
        mu_g=_f32(DF._MM_MU_GAIN * (DF._PAIR_MU if pair else 1.0)),
        om_g=_f32(DF._MM_OMEGA_GAIN * (DF._PAIR_OM if pair else 1.0)),
        omega_min=_f32(DF._OMEGA_MIN), omega_max=_f32(DF._OMEGA_MAX),
        ca_g=_f32(DF._COSTAS_ALPHA * (DF._PAIR_CA if pair else 1.0)),
        cb_g=_f32(DF._COSTAS_BETA * (DF._PAIR_CB if pair else 1.0)),
        clim=clim, leak_th=_f32(np.float32(0.3) * np.float32(clim)))


_POLYS: dict = {}


def _device_polys(device) -> torch.Tensor:
    """(2, 6, 8) [bank, derivative] polynomials on `device` (the plain
    version's operands)."""
    key = str(device)
    if key not in _POLYS:
        _POLYS[key] = torch.from_numpy(_host_polys()).to(device)
    return _POLYS[key]


@lru_cache(maxsize=None)
def _host_polys() -> np.ndarray:
    """The same polynomials in host memory: the launcher passes them to
    the kernel by value (its constant bank)."""
    return np.ascontiguousarray(np.stack(DF._bank_polys()), np.float32)


def mm_costas_plain(mfr, mfi, st0, n_chunks: int, emit_syms: bool = True,
                    tail_re=None, tail_im=None, cfreq_trace=None,
                    f0_trace=None):
    """Plain PyTorch K2 (see the module docstring for the layout).  A list
    given as cfreq_trace receives each group's Costas frequency (C,) as
    the group's leak decision reads it; one given as f0_trace each group's
    interpolated samples before the Costas rotation, a (G, C) pair, as
    the timing error's sgn() reads them."""
    T, C = mfr.shape
    er = torch.cat([tail_re, mfr], dim=0)          # (T + 7, C)
    ei = torch.cat([tail_im, mfi], dim=0)
    pair = n_chunks % 2 == 0
    H = 2 if pair else 1
    G = H * DF.K_SYM
    k = _gains(pair)
    polys = _device_polys(mfr.device)
    dev = mfr.device
    kk = torch.arange(G, dtype=torch.float32, device=dev)[:, None]
    pos, omega, cphase, cfreq, ph2 = (st0[i].clone() for i in range(5))
    prev_sym = st0[5].to(torch.int32)
    sgn = lambda v: torch.where(v > 0, 1.0, -1.0)
    remap = torch.from_numpy(_DIFF_REMAP).to(dev)
    outs = {n: [] for n in ("sym_re", "sym_im", "dibits", "valid", "dist")}
    for _ in range(n_chunks // H):
        p = pos[None, :] + omega[None, :] * kk              # (G, C)
        fl = torch.floor(p)
        mu = p - fl
        ipos = fl.to(torch.int64)
        valid = ipos < T
        safe = ipos.clamp(0, T - 1)
        f0r = torch.zeros_like(p)
        f0i = torch.zeros_like(p)
        d_r = torch.zeros_like(p)
        d_i = torch.zeros_like(p)
        for t in range(NTAPS):
            cb = polys[0, 0, t]
            cd = polys[1, 0, t]
            for j in range(1, 6):
                cb = cb * mu + polys[0, j, t]
                cd = cd * mu + polys[1, j, t]
            xr = er.gather(0, safe + t)
            xi = ei.gather(0, safe + t)
            f0r = f0r + cb * xr
            f0i = f0i + cb * xi
            d_r = d_r + cd * xr
            d_i = d_i + cd * xi
        if f0_trace is not None:
            f0_trace.append((f0r, f0i))
        zero = torch.zeros_like(p)
        err = torch.clamp(sgn(f0r) * d_r + sgn(f0i) * d_i, -4.0, 4.0)
        err = torch.where(valid, err, zero)
        err_sum = err.sum(dim=0)
        n_valid = valid.to(torch.float32).sum(dim=0)
        omega_n = torch.clamp(omega + k["om_g"] * err_sum, k["omega_min"],
                              k["omega_max"])
        pos = pos + omega * n_valid + k["mu_g"] * err_sum
        omega = omega_n
        # Costas with the frequency frozen over the group
        ca, sa = DF.rot_ramp(ph2 - PI4 - cphase, -PI4 - cfreq, G,
                             time_first=True)
        sr = f0r * ca - f0i * sa
        si = f0i * ca + f0r * sa
        cerr = torch.clamp(sgn(sr) * si - sgn(si) * sr, -1.0, 1.0)
        cerr = torch.where(valid, cerr, zero)
        cerr_sum = cerr.sum(dim=0)
        if cfreq_trace is not None:
            cfreq_trace.append(cfreq)
        leak = torch.where(cfreq.abs() > k["leak_th"], 0.05, 0.0)
        cfreq = torch.clamp((1.0 - leak) * cfreq + k["cb_g"] * cerr_sum,
                            -k["clim"], k["clim"])
        cphase_n = cphase + cfreq * n_valid + k["ca_g"] * cerr_sum
        cphase = cphase_n - TWO_PI * torch.floor((cphase_n + PI) / TWO_PI)
        dph2 = torch.where(valid, PI4, 0.0).sum(dim=0)
        ph2 = torch.remainder(ph2 - dph2, TWO_PI)
        # differential extraction
        a = (si < 0).to(torch.int32)
        b = (sr < 0).to(torch.int32)
        quad = (a << 1) | (a ^ b)
        prev = torch.cat([prev_sym[None, :], quad[:-1]], dim=0)
        diff = (quad - prev) & 3
        dibit = remap[diff]
        nv = valid.sum(dim=0)
        last_q = quad.gather(0, (nv - 1).clamp(min=0)[None, :])[0]
        prev_sym = torch.where(nv > 0, last_q, prev_sym).to(torch.int32)
        ideal_r = torch.where(b.bool(), -0.7071, 0.7071)
        ideal_i = torch.where(a.bool(), -0.7071, 0.7071)
        amp = torch.rsqrt(sr * sr + si * si + 1e-12)
        outs["sym_re"].append(sr)
        outs["sym_im"].append(si)
        outs["dibits"].append(dibit.to(torch.int32))
        outs["valid"].append(valid.to(torch.int32))
        outs["dist"].append((ideal_r * si - ideal_i * sr).abs() * amp)
    st_out = torch.stack([pos - T, omega, cphase, cfreq, ph2,
                          prev_sym.to(torch.float32), st0[6], st0[7]])
    cat = {n: torch.cat(v, dim=0) for n, v in outs.items()}
    syms = [cat["sym_re"], cat["sym_im"]] if emit_syms else []
    return tuple(syms + [cat["dibits"], cat["valid"], cat["dist"], st_out])


def mm_costas(mfr, mfi, st0, n_chunks: int, emit_syms: bool = True,
              tail_re=None, tail_im=None):
    """K2 on CUDA tensors, its plain version on CPU tensors.  Returns
    (sym_re, sym_im,) dibits, valid, dist, st_out."""
    if mfr.device.type == "cpu":
        return mm_costas_plain(mfr, mfi, st0, n_chunks, emit_syms, tail_re,
                               tail_im)
    if mfr.device.type != "cuda":
        raise ValueError(f"mm_costas: unsupported device {mfr.device}")
    T, C = mfr.shape
    for t, shp, nm in ((mfr, (T, C), "mfr"), (mfi, (T, C), "mfi"),
                       (st0, (8, C), "st0"),
                       (tail_re, (NTAPS - 1, C), "tail_re"),
                       (tail_im, (NTAPS - 1, C), "tail_im")):
        if t is None or t.dtype != torch.float32 \
                or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(f"mm_costas: {nm} must be contiguous float32 "
                             f"{shp}")
    pair = n_chunks % 2 == 0
    G = (2 if pair else 1) * DF.K_SYM
    S = n_chunks * DF.K_SYM
    dev = mfr.device
    sym_r = torch.empty((S, C), dtype=torch.float32, device=dev) \
        if emit_syms else None
    sym_i = torch.empty_like(sym_r) if emit_syms else None
    dib = torch.empty((S, C), dtype=torch.int32, device=dev)
    val = torch.empty_like(dib)
    dist = torch.empty((S, C), dtype=torch.float32, device=dev)
    st_out = torch.empty((8, C), dtype=torch.float32, device=dev)
    k = _gains(pair)
    polys = _host_polys()
    lib = _build.load()
    err = lib.launch_mm_costas(
        mfr.data_ptr(), mfi.data_ptr(), tail_re.data_ptr(), tail_im.data_ptr(),
        st0.data_ptr(),
        polys.ctypes.data,
        sym_r.data_ptr() if emit_syms else None,
        sym_i.data_ptr() if emit_syms else None,
        dib.data_ptr(), val.data_ptr(), dist.data_ptr(), st_out.data_ptr(),
        T, C, n_chunks * DF.K_SYM // G, G,
        k["mu_g"], k["om_g"], k["omega_min"], k["omega_max"], k["ca_g"],
        k["cb_g"], k["clim"], k["leak_th"], PI4,
        _build.stream_of(mfr))
    _build.check(err, "mm_costas")
    mm_costas.launches += 1
    syms = [sym_r, sym_i] if emit_syms else []
    return tuple(syms + [dib, val, dist, st_out])


mm_costas.launches = 0          # K2 kernel launches in this process
