"""Audio output path: 8 kHz decoded voice -> audio-rate stereo stream
(port of tetra_tpu/voice/audio_out.py; the resampler runs on the output's
torch device).

Parity with the reference's audio tail (main.cpp:96-103): rational resampler
from the codec rate to the audio sink rate plus mono-to-stereo conversion,
with silence padding so the audio clock keeps running when no voice decodes
(osmotetra_dec.h:182-200 pads 8/36 of the input symbol rate).
"""

from __future__ import annotations

from math import gcd

import numpy as np

from .. import resolve_device
from ..parallel.channelizer import resample


class AudioOutput:
    def __init__(self, out_rate: int = 48_000, in_rate: int = 8_000,
                 device=None):
        """device: the resampler's torch device, the current CUDA device
        unless the caller asks for the CPU."""
        self.in_rate = in_rate
        self.device = resolve_device(device)
        self.set_out_rate(out_rate)

    def set_out_rate(self, out_rate: int) -> None:
        """Runtime sample-rate change (the reference's
        sampleRateChangeHandler, main.cpp:416-422: resampler stop ->
        setOutSamplerate -> start; the stateless block resampler here has
        no stream state to reset)."""
        g = gcd(out_rate, self.in_rate)
        self.L, self.M = out_rate // g, self.in_rate // g
        self.out_rate = out_rate

    def render(self, pcm8k: np.ndarray, stereo: bool = True) -> np.ndarray:
        """s16 mono @ 8 kHz -> float32 @ out_rate, mono or interleaved stereo."""
        x = np.asarray(pcm8k, np.float32) / 32768.0
        if len(x) < 16:
            x = np.pad(x, (0, 16 - len(x)))
        y = resample(x[None].astype(np.complex64), self.L, self.M,
                     self.device)[0].real
        y = y.astype(np.float32)
        if stereo:
            return np.repeat(y, 2)  # interleaved L/R (convert::MonoToStereo)
        return y

    def silence(self, n_in_samples: int, stereo: bool = True) -> np.ndarray:
        n = n_in_samples * self.L // self.M
        return np.zeros(n * (2 if stereo else 1), np.float32)
