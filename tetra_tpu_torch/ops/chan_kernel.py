"""K4 (polyphase fold + DFT + hop-phase flip) and K3 (K4 + the streaming
18/25 resample): the wideband front end.

Ports of the TPU kernels tetra_tpu/ops/chan_pallas.py:fold_dft (K4) and
:fold_dft_resample (K3).  The CUDA source is csrc/chan.cu; the plain
PyTorch versions are the channelizer's composition (fold by shifted
slices, DFT by matmul against the f32 basis, sign flip; then the
superblock-matrix resampler).  fold_dft_resample makes one call into the
library, which launches the K4 kernel and then the resample kernel; one K3
call counts one launch on fold_dft's `launches` and one on its own.
resample wraps the resample kernel alone.  K4's kernel computes the DFT as
a Stockham FFT for n_ch a power of two from 16 to 1024 (twiddle table
from _tables) and as a matrix product against the W basis otherwise.

Layout: z is the hop-reshaped wideband block (n_out + 95, n_ch/2) float32;
outputs are frame-major (rows = 50 kHz or 36 kHz frames, columns =
channels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import channelizer as CH
from . import _build

L_RS, M_RS = 18, 25

_CONST: dict = {}


def _fold_weights(prototype: np.ndarray, n_ch: int) -> np.ndarray:
    """(2*TPB, hop) F with F[s, c] = h[s*hop + c]: the fold weight of input
    row m+s, branch column c (s = 2j + d encodes tap j, half d)."""
    return prototype.reshape(-1, n_ch // 2).astype(np.float32)


def _resamp_taps() -> tuple[np.ndarray, np.ndarray]:
    """Per output phase p: the 24 taps over input rows off[p] + t of the
    [history | block] stream (the nonzero band of _resamp_matrix)."""
    bank = CH._resamp_bank(L_RS, M_RS)
    coef = np.stack([bank[(p * M_RS) % L_RS][::-1] for p in range(L_RS)])
    off = np.array([(p * M_RS) // L_RS for p in range(L_RS)], np.int32)
    return np.ascontiguousarray(coef, np.float32), off


def _fft_path(n_ch: int) -> bool:
    """Whether csrc/chan.cu:launch_fold_dft takes its FFT kernel (power of
    two n_ch in [16, 1024]) rather than its matrix-DFT kernel."""
    return 16 <= n_ch <= 1024 and n_ch & (n_ch - 1) == 0


def _twiddles(n_ch: int) -> np.ndarray:
    """(n_ch, 2) float32 [re, im] of exp(-2 pi i t / n_ch), t < n_ch:
    computed in float64, rounded once (channelizer._dft_basis's sign)."""
    w = np.exp(-2j * np.pi * np.arange(n_ch) / n_ch).astype(np.complex64)
    return np.ascontiguousarray(w.view(np.float32).reshape(n_ch, 2))


def _resample_tables(device):
    """The resample's taps coef (18, 24) and offsets off (18,)."""
    key = ("rs", str(device))
    if key not in _CONST:
        _CONST[key] = tuple(torch.from_numpy(a).to(device)
                            for a in _resamp_taps())
    return _CONST[key]


def _tables(n_ch: int, device):
    """Fold weights F, twiddles, resample taps coef and offsets off."""
    key = (n_ch, str(device))
    if key not in _CONST:
        arrs = (_fold_weights(CH._prototype(n_ch), n_ch), _twiddles(n_ch))
        _CONST[key] = tuple(torch.from_numpy(a).to(device) for a in arrs) \
            + _resample_tables(device)
    return _CONST[key]


def _dft_tables(n_ch: int, device):
    """(Wtr, Wti): the (n_ch, n_ch) f32 DFT basis, [b][k], for the plain
    version and the matrix-DFT kernel."""
    key = ("W", n_ch, str(device))
    if key not in _CONST:
        Wr, Wi = CH._dft_basis(n_ch)
        _CONST[key] = (torch.from_numpy(np.ascontiguousarray(Wr.T)).to(device),
                       torch.from_numpy(np.ascontiguousarray(Wi.T)).to(device))
    return _CONST[key]


def fold_dft_plain(zr, zi, n_ch: int):
    """Plain PyTorch K4: zr/zi (n_out + 2*TPB - 1, hop) -> frame-major
    (n_out, n_ch) yr, yi with the (-1)^(m k) flip applied."""
    F = _tables(n_ch, zr.device)[0]
    Wtr, Wti = _dft_tables(n_ch, zr.device)
    n_s = F.shape[0]
    n_out = zr.shape[0] - (n_s - 1)
    acc = [[0.0, 0.0], [0.0, 0.0]]            # [re/im][d]
    for s in range(n_s):
        d = s % 2
        acc[0][d] = acc[0][d] + zr[s:s + n_out] * F[s]
        acc[1][d] = acc[1][d] + zi[s:s + n_out] * F[s]
    fr = torch.cat(acc[0], dim=-1)            # branch order b = d*hop + c
    fi = torch.cat(acc[1], dim=-1)
    yr = fr @ Wtr - fi @ Wti
    yi = fr @ Wti + fi @ Wtr
    m = torch.arange(n_out, device=zr.device)
    k = torch.arange(n_ch, device=zr.device)
    flip = torch.where((m[:, None] * k[None, :]) % 2 == 1, -1.0, 1.0)
    return yr * flip, yi * flip


def fold_dft_resample_plain(zr, zi, hr, hi, n_ch: int, t36: int):
    """Plain PyTorch K3: fold + DFT + flip, then the streaming resample.
    hr/hi: (23, n_ch) stream history.  Returns (t36, n_ch) rr, ri and the
    next block's (23, n_ch) history."""
    yr, yi = fold_dft_plain(zr, zi, n_ch)
    return CH._resample_stream_block_fm(yr, yi, hr, hi, t36)


def _check_z(zr, zi, n_ch: int):
    hop = n_ch // 2
    for z, nm in ((zr, "zr"), (zi, "zi")):
        if z.dtype != torch.float32 or z.dim() != 2 or z.shape[1] != hop \
                or not z.is_contiguous() or z.shape != zr.shape:
            raise ValueError(f"{nm}: need contiguous float32 (rows, {hop})")
    n_out = zr.shape[0] - (2 * CH.TAPS_PER_BRANCH - 1)
    if n_out <= 0:
        raise ValueError(f"block of {zr.shape[0]} rows is too short")
    return n_out


def _check_device(x, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_resample(hr, hi, device, C: int, t50: int, t36: int) -> None:
    """The stream history's shape and the 18/25 rate: t50 a multiple of 25
    and t36 = t50 * 18 / 25."""
    pad = CH.RS_TAPS_PER_PHASE - 1
    for h, nm in ((hr, "hr"), (hi, "hi")):
        if h.dtype != torch.float32 or tuple(h.shape) != (pad, C) \
                or not h.is_contiguous() or h.device != device:
            raise ValueError(f"{nm}: need contiguous float32 ({pad}, {C})"
                             f" on {device}")
    if t50 % M_RS or t36 * M_RS != t50 * L_RS:
        raise ValueError(f"t36={t36} does not match t50={t50} at 18/25")


def _resample_outputs(t36: int, C: int, device, scratch: int = 0):
    """One allocation (2, t36 + 23 + scratch, C), a plane each for re and
    im: the (t36, C) rows, the next block's (23, C) history, then `scratch`
    rows for the caller.  Returns the views (rr, ri, tr, ti) and the device
    pointers of (rr, ri, tr, ti, scratch re, scratch im)."""
    pad = CH.RS_TAPS_PER_PHASE - 1
    n = t36 + pad + scratch
    buf = torch.empty((2, n, C), dtype=torch.float32, device=device)
    rows, hist, plane = (t36, C), (pad, C), n * C
    views = (buf.as_strided(rows, (C, 1), 0),
             buf.as_strided(rows, (C, 1), plane),
             buf.as_strided(hist, (C, 1), t36 * C),
             buf.as_strided(hist, (C, 1), plane + t36 * C))
    base = buf.data_ptr()
    at = (0, plane, t36 * C, plane + t36 * C, (t36 + pad) * C,
          plane + (t36 + pad) * C)
    return views, tuple(base + 4 * a for a in at)


def _fold_args(zr, zi, n_ch: int):
    """K4's launch arguments before y: z, fold weights, twiddles and the W
    basis (null pointers on the FFT path); and n_s."""
    F, tw, _, _ = _tables(n_ch, zr.device)
    W = (None, None) if _fft_path(n_ch) else tuple(
        w.data_ptr() for w in _dft_tables(n_ch, zr.device))
    return (zr.data_ptr(), zi.data_ptr(), F.data_ptr(), tw.data_ptr(),
            *W), int(F.shape[0])


def _ptrs(*ts):
    return tuple(t.data_ptr() for t in ts)


def fold_dft(zr, zi, n_ch: int):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if zr.device.type == "cpu":
        return fold_dft_plain(zr, zi, n_ch)
    _check_device(zr, "fold_dft")
    n_out = _check_z(zr, zi, n_ch)
    args, n_s = _fold_args(zr, zi, n_ch)
    yr = torch.empty((n_out, n_ch), dtype=torch.float32, device=zr.device)
    yi = torch.empty_like(yr)
    err = _build.load().launch_fold_dft(*args, *_ptrs(yr, yi), n_out, n_ch,
                                        n_s, _build.stream_of(zr))
    _build.check(err, "fold_dft")
    fold_dft.launches += 1
    return yr, yi


fold_dft.launches = 0       # K4 (fold + DFT) kernel launches in this process


def resample(yr, yi, hr, hi, t36: int):
    """The streaming 18/25 resample alone on CUDA tensors (K3's second
    kernel), channelizer._resample_stream_block_fm on CPU tensors.
    yr/yi: (t50, C) 50 kHz rows; hr/hi: (23, C) stream history.  Returns
    (t36, C) rr, ri and the next block's (23, C) history."""
    if yr.device.type == "cpu":
        return CH._resample_stream_block_fm(yr, yi, hr, hi, t36)
    _check_device(yr, "resample")
    for y, nm in ((yr, "yr"), (yi, "yi")):
        if y.dtype != torch.float32 or y.dim() != 2 \
                or not y.is_contiguous() or y.shape != yr.shape:
            raise ValueError(f"{nm}: need contiguous float32 (t50, C)")
    t50, C = yr.shape
    _check_resample(hr, hi, yr.device, C, t50, t36)
    out, ptrs = _resample_outputs(t36, C, yr.device)
    coef, off = _resample_tables(yr.device)
    err = _build.load().launch_resample(
        *_ptrs(yr, yi, hr, hi, coef, off), *ptrs[:4], t50, t36, C,
        _build.stream_of(yr))
    _build.check(err, "resample")
    resample.launches += 1
    return out


resample.launches = 0       # resample kernel launches by this wrapper


def fold_dft_resample(zr, zi, hr, hi, n_ch: int, t36: int):
    """K3 on CUDA tensors, its plain version on CPU tensors.  One C call
    launches the K4 kernel into a scratch y and the resample kernel after
    it; the resample kernel writes the next block's history.  One
    allocation holds the outputs and y (the host time of a call is close
    to the kernels' device time)."""
    if zr.device.type == "cpu":
        return fold_dft_resample_plain(zr, zi, hr, hi, n_ch, t36)
    _check_device(zr, "fold_dft_resample")
    n_out = _check_z(zr, zi, n_ch)
    _check_resample(hr, hi, zr.device, n_ch, n_out, t36)
    args, n_s = _fold_args(zr, zi, n_ch)
    coef, off = _resample_tables(zr.device)
    # the 50 kHz rows between the two kernels go to the outputs' buffer
    out, ptrs = _resample_outputs(t36, n_ch, zr.device, scratch=n_out)
    err = _build.load().launch_fold_dft_resample(
        *args, *ptrs[4:], *_ptrs(hr, hi, coef, off), *ptrs[:4], n_out, n_ch,
        n_s, t36, _build.stream_of(zr))
    _build.check(err, "fold_dft_resample")
    fold_dft.launches += 1
    fold_dft_resample.launches += 1
    return out


# K3's second kernel (the resample) launches in this process; its first is
# counted by fold_dft
fold_dft_resample.launches = 0
