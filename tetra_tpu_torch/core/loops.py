"""Second-order phase control loop as pure functions (port of
tetra_tpu/core/loops.py).

Every feedback stage of the reference (FLL, symbol timing, Costas) is
SDR++'s `PhaseControlLoop`: a 2nd-order alpha/beta loop with frequency
clamps.  Here the update is a pure function over an explicit (phase, freq)
state, vectorized over a channel axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def critically_damped(bandwidth: float, damping: float = np.sqrt(2.0) / 2.0
                      ) -> tuple[float, float]:
    """alpha/beta gains for a 2nd-order loop at the given noise bandwidth
    (the reference's closed form, src/main.cpp:77-82):
      denom = 1 + 2 zeta bw + bw^2
      alpha = 4 zeta bw / denom,  beta = 4 bw^2 / denom
    """
    denom = 1.0 + 2.0 * damping * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * damping * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return float(alpha), float(beta)


class PCLState(NamedTuple):
    phase: torch.Tensor  # (...,) float32
    freq: torch.Tensor   # (...,) float32


def pcl_advance(state: PCLState, error, alpha: float, beta: float,
                min_freq: float, max_freq: float,
                wrap_phase: bool = True,
                min_phase: float = -np.pi, max_phase: float = np.pi
                ) -> PCLState:
    """One loop update: freq += beta*err (clamped); phase += freq + alpha*err.

    With wrap_phase the phase is wrapped into [min_phase, max_phase] by
    adding/subtracting the span (the reference wraps rather than clamps).
    """
    freq = torch.clamp(state.freq + beta * error, min_freq, max_freq)
    phase = state.phase + freq + alpha * error
    if wrap_phase:
        span = max_phase - min_phase
        phase = phase - span * torch.floor((phase - min_phase) / span)
    return PCLState(phase=phase, freq=freq)
