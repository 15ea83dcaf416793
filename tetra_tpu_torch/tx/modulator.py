"""pi/4-DQPSK modulator with RRC pulse shaping, batched over channels (port
of tetra_tpu/tx/modulator.py).

Bit stream (MSB-first dibits) -> differential phase -> 18 ksym/s complex
symbols -> 2x upsample -> RRC pulse shaping at 36 ksps, on a torch device.
With tx.burst and tx.fec_enc it is the golden modulator of the fixtures.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from ..core import taps as T
from ..core.fir import fir_valid

# phase step per dibit, in units of pi/4 and in radians (ETSI table 9.14)
_DIBIT_STEP = np.array([1, 3, -1, -3], np.int64)
_DIBIT_PHASE = _DIBIT_STEP.astype(np.float32) * (np.pi / 4.0)


def _bits_tensor(bits, device) -> torch.Tensor:
    """bits as an int64 tensor: a tensor stays on its device unless one is
    named; anything else goes to `device` (the current CUDA device by
    default)."""
    if isinstance(bits, torch.Tensor):
        return bits.to(device if device is not None else bits.device,
                       torch.int64)
    return torch.as_tensor(np.asarray(bits), dtype=torch.int64,
                           device=resolve_device(device))


def bits_to_symbols(bits, phase0: float = 0.0, device=None) -> torch.Tensor:
    """Bit stream (..., 2K) -> pi/4-DQPSK unit-circle symbols (..., K),
    complex64.  Bits are consumed MSB-first in pairs; symbol k carries the
    cumulative phase phi_k = phi_{k-1} + dphi(dibit_k).

    The cumulative phase is summed exactly, as an integer count of pi/4
    steps mod 8, where the reference sums float32 radians: its phase
    drifts by float32 rounding as the stream grows (~1e-5 rad after 256
    symbols, ~1e-4 after 30,000), the port's does not."""
    bits = _bits_tensor(bits, device)
    dibits = (bits[..., 0::2] << 1) | bits[..., 1::2]
    steps = torch.from_numpy(_DIBIT_STEP).to(bits.device)[dibits]
    eighths = torch.remainder(torch.cumsum(steps, dim=-1), 8)
    phase = phase0 + eighths.to(torch.float32) * (np.pi / 4.0)
    return torch.polar(torch.ones_like(phase), phase)


def modulate(bits, sps: int = 2, rrc_taps: int = P.RRC_TAP_COUNT,
             rrc_alpha: float = P.RRC_ALPHA, phase0: float = 0.0,
             device=None) -> torch.Tensor:
    """Full modulator: bits (C, 2K) -> baseband IQ (C, K*sps) complex64.

    Impulse-train upsampling, then an RRC shaping filter (matched to the
    receiver's RRC at pi4dqpsk.cpp:18) scaled for unit symbol peaks."""
    syms = bits_to_symbols(bits, phase0, device)
    syms = syms.reshape(-1, syms.shape[-1])               # (C, K)
    C, K = syms.shape
    up = torch.zeros((C, K * sps), dtype=torch.complex64, device=syms.device)
    up[:, ::sps] = syms
    h = T.root_raised_cosine(rrc_taps, rrc_alpha, 1.0, float(sps))
    h = torch.from_numpy(np.asarray(h * sps, np.float32))
    pad = torch.zeros((C, h.shape[0] - 1), dtype=torch.complex64,
                      device=syms.device)
    return fir_valid(torch.cat([pad, up], dim=1), h)      # (C, K*sps)
