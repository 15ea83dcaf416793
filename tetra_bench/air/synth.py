"""Periodic wideband air: N x 25 kHz carriers, each a TETRA downlink of
one of a few cells, built by FFT placement on the device.

The air repeats exactly after a whole number of multiframes (a multiple
of 4, so the BSCH slot rule and the multiframe parity run on across the
wrap; every burst's symbols sum to 7 x pi/4 and the period holds a
multiple of 8 bursts, so the differential phase closes too).  Over one
period the shaped symbol stream of a carrier has the Fourier series

    X[m] = A[m mod M] * H(m / period)     (M symbols a period)

with A the DFT of the pi/4-DQPSK symbols and H the frequency response of
the 65-tap root-raised-cosine shaping filter (the program's TX fixture's
filter, tx.modulator, taken as zero-phase).  Each carrier's 25 kHz of
bins is placed at its channel, shifted by its CFO rounded to whole
cycles a period (whole bins), the band gets white noise drawn for one
period, and one inverse FFT gives the air: periodic by construction, so
slot grid, phase, filters and noise run on across the wrap and only the
multiframe number in the SYNC PDUs jumps back.

The traffic's voice arm and the configuration's crypto arm (downlink.py)
are drawn from the seed as well: each cell's codec frames, and the
encrypted cells' keys (cipher_arm; the harness writes them for the
receiver as a text keystore).

Sizes: a period of P multiframes has 25,000 * 1.02 * P bins per carrier
(204,000 at 8 multiframes), so 1024 carriers make 209 M complex samples
(0.84 GB a plane in float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import cipher
from . import protocol as P
from .downlink import Cell, Crypto, Voice, downlink


@dataclass
class Air:
    """The air and its ground truth.  re/im: float32 planes on the device,
    the period followed by its first `ext` samples again, so any span of
    up to `ext` samples from any offset is contiguous."""
    re: torch.Tensor
    im: torch.Tensor
    period: int                 # wide samples a period
    fs: float                   # wide sample rate, Hz
    period_slots: int
    cells: list                 # Cell per cell index
    cell_of: np.ndarray         # cell index per carrier, -1 where empty
    dibits: list                # per cell: (period_slots * 255,) uint8
    records: list               # per cell: list of slot records
    cfo_hz: np.ndarray          # per carrier, as placed (whole bins)
    start: int                  # the stream's first wide sample


def shaping_response(freqs_hz: np.ndarray) -> np.ndarray:
    """Zero-phase frequency response of the 2-sps RRC shaping filter at
    36 kHz, at the given frequencies (real)."""
    h = P.rrc_taps()
    c = (len(h) - 1) // 2
    k = np.arange(1, c + 1)
    return h[c] + 2.0 * (np.cos(2 * np.pi * np.outer(freqs_hz, k)
                                / P.SAMPLE_RATE) @ h[c + 1:])


def symbols_of(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dibits and unit pi/4-DQPSK symbols of a periodic bit stream; the
    cumulative phase must close over the period."""
    dib = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)
    eighths = np.cumsum(P.DIBIT_STEP[dib])
    if eighths[-1] % 8:
        raise ValueError("the stream's phase does not close over the period")
    return dib, np.exp(1j * np.pi / 4 * (eighths % 8))


def voice_of(spec: dict, i: int, seed: int) -> Voice:
    """Cell i's voice arm from a traffic mix's `voice`: {"timeslots": [tn,
    ...], "steals": [{"kind": "first" | "both", "timeslot": tn, "frames":
    [fn or null, ...]}, ...]}; cell i steals frame frames[i % len(frames)]
    of every multiframe (null: none; a later entry wins on the same slot).
    Its codec frames are drawn from the seed."""
    steals = {}
    for s in spec.get("steals", []):
        fn = s["frames"][i % len(s["frames"])]
        if fn is not None:
            if s["kind"] not in ("first", "both"):
                raise ValueError(f"unknown steal {s['kind']!r}")
            steals[(int(fn), int(s["timeslot"]))] = s["kind"]
    rng = np.random.default_rng([seed, 200 + i])
    return Voice(timeslots=frozenset(spec["timeslots"]),
                 frames=lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8),
                 steals=steals)


def cipher_arm(spec: dict | None, cells: list, seed: int):
    """({cell index: Crypto}, keystore text or None) of a configuration's
    `crypto`: {"algorithm": "TEA1", "cells": [i, ...], "cck_id": n}; the
    keys are drawn from the seed."""
    if spec is None:
        return {}, None
    if spec["algorithm"] != "TEA1":
        raise ValueError(f"unknown cipher {spec['algorithm']!r}")
    keys = cipher.cipher_keys(seed, spec["cells"])
    return ({i: Crypto(k, spec["cck_id"]) for i, k in keys.items()},
            cipher.keystore_text(cells, keys, spec["cck_id"]))


def build_air(carriers: int, cells: list, occupied: np.ndarray,
              period_multiframes: int, snr_db: float, cfo_max_hz: float,
              seed: int, device, ext: int, voice: dict | None = None,
              crypto: dict | None = None) -> Air:
    """Air for `carriers` channels; carrier c, where occupied, carries
    cells[c % len(cells)] at unit power, with a CFO drawn uniformly in
    +-cfo_max_hz and rounded to whole cycles a period, and a random
    phase; the band holds white noise snr_db under one carrier in each
    25 kHz channel.  voice and crypto: the traffic's and the
    configuration's arms (voice_of, cipher_arm), or signalling only.
    Everything random is drawn from `seed`."""
    if period_multiframes % 4:
        raise ValueError("the period must be a whole number of 4 "
                         "multiframes")
    period_slots = period_multiframes * P.SLOTS_PER_MULTIFRAME
    n_sym = period_slots * P.SYM_PER_TS
    period_s = n_sym / P.SYMBOL_RATE
    bins = round(P.CHANNEL_HZ * period_s)
    n = carriers * bins
    rng = np.random.default_rng([seed, 1])
    cfo_bins = np.rint(rng.uniform(-cfo_max_hz, cfo_max_hz, carriers)
                       * period_s).astype(np.int64)
    phase = rng.uniform(0.0, 2 * np.pi, carriers)
    start = int(rng.integers(0, n))

    ciphers, _ = cipher_arm(crypto, cells, seed)
    dibits, records, spectra = [], [], []
    for i, cell in enumerate(cells):
        arms = {}
        if voice is not None:
            arms["voice"] = voice_of(voice, i, seed)
        if i in ciphers:
            arms["crypto"] = ciphers[i]
            arms["wrap"] = period_multiframes
        bits, recs = downlink(cell, period_slots,
                              np.random.default_rng([seed, 100 + i]), **arms)
        dib, sym = symbols_of(bits)
        dibits.append(dib)
        records.append(recs)
        spectra.append(torch.from_numpy(np.fft.fft(sym)).to(device))
    spectra = torch.stack(spectra)                       # (cells, n_sym)

    smax = int(np.abs(cfo_bins).max()) if carriers else 0
    grid = np.arange(-bins // 2 - smax, bins // 2 + smax)
    H = torch.from_numpy(shaping_response(grid / period_s)).to(device)
    m = torch.arange(-bins // 2, bins // 2, device=device)

    X = torch.zeros(n, dtype=torch.complex64, device=device)
    cell_of = np.where(occupied, np.arange(carriers) % len(cells), -1)
    occ = np.nonzero(occupied)[0]
    for g in range(0, len(occ), 32):
        cs = occ[g:g + 32]
        shift = torch.from_numpy(cfo_bins[cs]).to(device)[:, None]
        src = m[None, :] - shift                          # (g, bins)
        vals = spectra[torch.from_numpy(cell_of[cs]).to(device)[:, None],
                       torch.remainder(src, n_sym)] * H[src + bins // 2
                                                         + smax]
        vals = vals * torch.from_numpy(np.exp(1j * phase[cs])).to(
            device)[:, None]
        vals = vals * (n / vals.abs().square().sum(dim=1, keepdim=True)
                       .sqrt())
        dst = torch.remainder(torch.from_numpy(cs * bins).to(device)[:, None]
                              + m[None, :], n)
        X[dst.reshape(-1)] = vals.reshape(-1).to(torch.complex64)
    del spectra, H

    # white noise: snr_db under a unit carrier in each 25 kHz channel
    sigma = float(np.sqrt(10.0 ** (-snr_db / 10.0) * n * n / bins / 2.0))
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    step = 1 << 24
    for a in range(0, n, step):
        k = min(step, n - a)
        X[a:a + k] += torch.complex(
            torch.randn(k, generator=gen, device=device),
            torch.randn(k, generator=gen, device=device)) * sigma
    x = torch.fft.ifft(X)
    del X
    parts = [x] + [x[:min(n, ext - a)] for a in range(0, ext, n)]
    xe = torch.cat(parts)
    del x, parts
    re, im = xe.real.contiguous(), xe.imag.contiguous()
    return Air(re=re, im=im, period=n, fs=carriers * float(P.CHANNEL_HZ),
               period_slots=period_slots, cells=cells,
               cell_of=cell_of, dibits=dibits, records=records,
               cfo_hz=cfo_bins / period_s, start=start)


def cells_of(spec: dict) -> list:
    """The configuration's cells: MCC, MNC mnc0 + i, colour code cc0 + i."""
    return [Cell(mcc=spec["mcc"], mnc=spec["mnc0"] + i, cc=spec["cc0"] + i)
            for i in range(spec["count"])]
