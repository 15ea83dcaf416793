"""Channel impairment models for fixtures and BER sweeps (port of
tetra_tpu/tx/channel.py): carrier-frequency offset, phase offset, gain,
AWGN at a target SNR, and integer timing offset.

The noise comes from an explicit torch.Generator where the reference takes
a jax.random key, so its samples differ from the reference's by
construction; their statistics and every other stage agree.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _iq_tensor(iq, device=None) -> torch.Tensor:
    """iq as a complex64 tensor: a tensor stays on its device unless one is
    named; anything else goes to `device` (the current CUDA device by
    default)."""
    if isinstance(iq, torch.Tensor):
        dev = device if device is not None else iq.device
        return iq.to(dev, torch.complex64)
    return torch.as_tensor(np.asarray(iq, np.complex64),
                           device=resolve_device(device))


def apply_cfo(iq, cfo_hz: float, sample_rate: float, phase0: float = 0.0,
              device=None) -> torch.Tensor:
    """Rotate by a carrier frequency offset (Hz at the given sample rate)."""
    iq = _iq_tensor(iq, device)
    n = torch.arange(iq.shape[-1], dtype=torch.float32, device=iq.device)
    ang = 2.0 * np.pi * cfo_hz / sample_rate * n + phase0
    return iq * torch.polar(torch.ones_like(ang), ang)


def add_awgn(iq, snr_db: float, generator: torch.Generator,
             signal_power: float | None = None, device=None) -> torch.Tensor:
    """Add complex AWGN for a target SNR (dB) relative to signal power
    (measured from the block if signal_power is None).  The generator must
    live on the samples' device; one seed gives one noise sequence there."""
    iq = _iq_tensor(iq, device)
    if signal_power is None:
        signal_power = torch.mean(iq.abs() ** 2)
    noise_power = signal_power / (10.0 ** (snr_db / 10.0))
    std = (noise_power / 2.0) ** 0.5
    nr = torch.randn(iq.shape, generator=generator, device=iq.device)
    ni = torch.randn(iq.shape, generator=generator, device=iq.device)
    return iq + torch.complex(nr, ni) * std


def channel(iq, generator: torch.Generator, snr_db: float = 30.0,
            cfo_hz: float = 0.0, sample_rate: float = 36000.0,
            gain: float = 1.0, phase0: float = 0.0, delay_samples: int = 0,
            device=None) -> torch.Tensor:
    """Composite impairment: delay -> gain/phase/CFO -> AWGN."""
    iq = _iq_tensor(iq, device)
    if delay_samples:
        iq = torch.cat([iq.new_zeros(iq.shape[:-1] + (delay_samples,)), iq],
                       dim=-1)
    iq = iq * gain
    iq = apply_cfo(iq, cfo_hz, sample_rate, phase0)
    return add_awgn(iq, snr_db, generator)
