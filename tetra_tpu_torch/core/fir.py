"""Batched streaming FIR filters, channels x time (port of
tetra_tpu/core/fir.py).

Valid-mode convolutions over a block with an (M-1)-sample carried history
(overlap-save streaming).  Complex data is decomposed into real
convolutions on float32 planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device


def _conv_valid_real(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Valid-mode convolution y[n] = sum_m h[m] x[n+M-1-m], batched.
    x: (C, T) float32, h: (M,) float32 -> (C, T-M+1)."""
    # conv1d is a correlation: correlating with the flipped taps convolves
    return F.conv1d(x[:, None, :], torch.flip(h, (0,))[None, None, :])[:, 0]


def fir_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Valid-mode FIR for complex or real x with complex or real taps h:
    y[:, n] = sum_m h[m] * x[:, n + M - 1 - m].  Complex in or complex taps
    give complex64, else float32."""
    h = h.to(x.device)
    if x.is_complex() or h.is_complex():
        xr = x.real.float() if x.is_complex() else x.float()
        xi = x.imag.float() if x.is_complex() else torch.zeros_like(xr)
        hr = h.real.float() if h.is_complex() else h.float()
        if h.is_complex():
            hi = h.imag.float()
            rr = _conv_valid_real(xr, hr) - _conv_valid_real(xi, hi)
            ii = _conv_valid_real(xr, hi) + _conv_valid_real(xi, hr)
        else:
            rr = _conv_valid_real(xr, hr)
            ii = _conv_valid_real(xi, hr)
        return torch.complex(rr, ii)
    return _conv_valid_real(x.float(), h.float())


def fir_stream(x: torch.Tensor, h: torch.Tensor, tail: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming FIR over a (C, T) block with a (C, M-1) carried tail:
    the history goes in front of the block, a valid convolution gives T
    outputs, and the last M-1 samples are the next tail (identical to
    filtering the unbroken stream)."""
    M = h.shape[0]
    ext = torch.cat([tail, x], dim=1)            # (C, M-1+T)
    y = fir_valid(ext, h)                        # (C, T)
    new_tail = ext[:, -(M - 1):] if M > 1 else tail
    return y, new_tail


def make_fir_tail(channels: int, taps: int, dtype=torch.complex64,
                  device=None) -> torch.Tensor:
    """A zero (channels, taps-1) history on `device` (the current CUDA
    device unless the caller asks for the CPU)."""
    return torch.zeros((channels, taps - 1), dtype=dtype,
                       device=resolve_device(device))


def fir_stream_pair(xr: torch.Tensor, xi: torch.Tensor, h: torch.Tensor,
                    tail_re: torch.Tensor, tail_im: torch.Tensor):
    """Streaming real-tap FIR over a (C, T) pair with a (C, M-1) carried
    history (overlap-save).  Returns (yr, yi, new_tail_re, new_tail_im)."""
    M = h.shape[0]
    er = torch.cat([tail_re, xr], dim=1)
    ei = torch.cat([tail_im, xi], dim=1)
    yr = _conv_valid_real(er, h)
    yi = _conv_valid_real(ei, h)
    return yr, yi, er[:, -(M - 1):], ei[:, -(M - 1):]


def fir_stream_pair_mm(xr: torch.Tensor, xi: torch.Tensor, h: torch.Tensor,
                       tail_re: torch.Tensor, tail_im: torch.Tensor):
    """The reference's banded-matmul form of fir_stream_pair (a workaround
    for its TPU backend's conv lowering), with its preconditions: a 65-tap
    filter and T a multiple of 64.  The same overlap-save windows, computed
    here by fir_stream_pair's conv1d."""
    M = h.shape[0]
    if M - 1 != 64 or xr.shape[1] % 64:
        raise ValueError(f"need a 65-tap filter and T % 64 == 0, got "
                         f"{M} taps and T = {xr.shape[1]}")
    return fir_stream_pair(xr, xi, h, tail_re, tail_im)
