"""Demod filter tables and loop constants (port of tetra_tpu/rx/demod.py).

Only the pieces the chunked production chain (rx/demod_fast.py) and the
per-channel receiver read are ported here: the RRC / band-edge /
interpolator tables, the reference loop constants and dibits_to_bits.  The
per-sample parity chain is not ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import numpy as np

from .. import params as P
from ..core import taps as taps_mod


def critically_damped(bandwidth: float, damping: float = np.sqrt(2.0) / 2.0
                      ) -> tuple[float, float]:
    """alpha/beta gains of a 2nd-order loop (tetra_tpu/core/loops.py)."""
    denom = 1.0 + 2.0 * damping * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * damping * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return float(alpha), float(beta)


_, _FLL_BETA = critically_damped(P.FLL_LOOP_BANDWIDTH)  # frequency only
_COSTAS_ALPHA, _COSTAS_BETA = critically_damped(P.COSTAS_LOOP_BANDWIDTH)
_MM_MU_GAIN, _MM_OMEGA_GAIN = critically_damped(
    P.CLOCK_RECOVERY_BW, P.CLOCK_RECOVERY_DAMPING)

_OMEGA = 2.0  # samples per symbol
_OMEGA_MIN = _OMEGA * (1.0 - P.CLOCK_RECOVERY_REL_LIMIT)
_OMEGA_MAX = _OMEGA * (1.0 + P.CLOCK_RECOVERY_REL_LIMIT)
_FLL_FREQ_LIM = np.pi / 2.0

# quadrant sym = (im<0)<<1 | ((im<0)!=(re<0)); diff = (sym - prev) mod 4;
# the remap swaps 0b10/0b11
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


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """Unpack dibit stream to bits, MSB first (bit_unpacker.cpp:4-11)."""
    dibits = np.asarray(dibits, np.uint8)
    out = np.empty(dibits.shape[:-1] + (dibits.shape[-1] * 2,), np.uint8)
    out[..., 0::2] = (dibits >> 1) & 1
    out[..., 1::2] = dibits & 1
    return out
