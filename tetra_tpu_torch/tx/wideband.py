"""Wideband TX fixtures for the port (no jax).

Copies of tetra_tpu/tx/wideband.synthesize_wideband (host numpy) and of
the benchmark's heterogeneous_fleet_iq (bench.py): same code, same seeds,
same outputs; and the port of tetra_tpu/tx/wideband.assemble_wideband,
whose resampler runs on a torch device.  The cell bit streams come from
the port's own tx/cell.py; voice_cell_air adds traffic, slot stealing and
TEA1 encryption to cell_air's multiplex, and marginal_air puts carriers
at marginal SNR, some with a dropout and a cell change.
cell_air_device builds cell_air's recipe on a torch device, for the wide
configurations, where the numpy synthesis takes minutes.
"""

from __future__ import annotations

import numpy as np

from .. import params as P
from ..core.taps import root_raised_cosine
from ..crypto.state import KEYTYPE_CCK_SCK, KSG_TEA1, CryptoState, KeyStore
from ..rx.tdma import TdmaTime
from .cell import CellConfig, downlink_bits
from .modulator import _DIBIT_PHASE


def _shaped(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """pi/4-DQPSK symbols upsampled to 2 sps, and the RRC shaping taps."""
    dib = (bits[0::2] << 1) | bits[1::2]
    phase = np.cumsum(np.asarray(_DIBIT_PHASE)[dib])
    syms = np.exp(1j * phase).astype(np.complex64)
    up = np.zeros(2 * len(syms), np.complex64)
    up[::2] = syms
    h = np.asarray(root_raised_cosine(P.RRC_TAP_COUNT, P.RRC_ALPHA, 1.0, 2.0),
                   np.float32) * 2.0
    return up, h


def synthesize_wideband(bitmat: np.ndarray, n_ch: int,
                        cfo_hz: np.ndarray | float = 0.0,
                        snr_db: float | None = None,
                        seed: int = 0) -> np.ndarray:
    """One TETRA downlink per 25 kHz carrier by FFT placement.

    bitmat: (n_ch, L) downlink bit streams.  Each stream is modulated at
    36 kHz, CFO-rotated, polyphase-resampled to 50 kHz and placed at its
    carrier (circular in time).  Returns complex64 at n_ch * 25 kHz."""
    from scipy.signal import resample_poly

    rng = np.random.default_rng(seed)
    n_ch_sig, L = bitmat.shape
    if n_ch_sig != n_ch:
        raise ValueError(f"bitmat has {n_ch_sig} rows for {n_ch} channels")
    cfo = np.broadcast_to(np.asarray(cfo_hz, np.float64), (n_ch,))
    h_len = P.RRC_TAP_COUNT
    T36 = (L // 2) * 2 - (h_len - 1)
    T36 -= T36 % 36
    T50 = T36 * 25 // 18
    n_wide = T50 * (n_ch // 2)
    spec = np.zeros(n_wide, np.complex128)
    t36 = np.arange(T36) / P.SAMPLE_RATE
    for c in range(n_ch):
        up, h = _shaped(bitmat[c])
        x = np.convolve(up, h, mode="full")[:T36 + len(h) - 1][len(h) - 1:]
        x = x[:T36]
        if cfo[c]:
            x = x * np.exp(2j * np.pi * cfo[c] * t36)
        y = resample_poly(x, 25, 18)[:T50]
        Y = np.fft.fft(y, T50)
        k0 = c * (T50 // 2)
        idx = (k0 + np.concatenate([np.arange(0, T50 // 2),
                                    np.arange(-T50 // 2, 0)])) % n_wide
        spec[idx] += Y * (n_wide / T50)
    wide = np.fft.ifft(spec).astype(np.complex64)
    if snr_db is not None:
        sig_p = np.mean(np.abs(wide) ** 2) / n_ch
        noise_p = sig_p * n_ch * 10 ** (-snr_db / 10)
        nr = rng.standard_normal(n_wide).astype(np.float32)
        ni = rng.standard_normal(n_wide).astype(np.float32)
        wide = wide + np.sqrt(noise_p / 2) * (nr + 1j * ni)
    return wide.astype(np.complex64)


def assemble_wideband(channels: dict[int, np.ndarray], n_ch: int,
                      amplitude: float = 1.0, device=None) -> np.ndarray:
    """channels: {channel_index: complex IQ at 36 kHz}.  Returns wideband
    complex64 at n_ch*25 kHz with each signal centered at k*25 kHz.  The
    36 kHz -> n_ch*25 kHz resampling and the mixing run on `device` (the
    current CUDA device unless the caller asks for the CPU), one channel
    at a time into one complex64 sum there; each channel's mixer is
    computed in float64, as in the reference, before the channel is
    rounded to complex64 and added."""
    from math import gcd

    import torch

    from .. import resolve_device
    from ..parallel.channelizer import RS_TAPS_PER_PHASE, _resample_block
    device = resolve_device(device)
    fs = n_ch * 25_000
    g = gcd(fs, 36_000)
    L, M = fs // g, 36_000 // g
    n_in = min(len(iq) for iq in channels.values())
    length = (n_in - RS_TAPS_PER_PHASE) * L // M
    t = torch.arange(length, dtype=torch.float64, device=device) / fs
    wide = torch.zeros(length, dtype=torch.complex64, device=device)
    for k, iq in channels.items():
        iq = np.asarray(iq, np.complex64)[None, :n_in]
        yr, yi = _resample_block(
            torch.from_numpy(iq.real.copy()).to(device),
            torch.from_numpy(iq.imag.copy()).to(device), n_in, L, M)
        f0 = k * 25_000.0
        if f0 > fs / 2:
            f0 -= fs
        ang = (2j * np.pi * f0).imag * t
        y = torch.complex(yr[0], yi[0]).to(torch.complex128)
        wide += (y * torch.polar(torch.ones_like(ang), ang)
                 * amplitude).to(torch.complex64)
    return wide.cpu().numpy()


def _largest_prime_factor(n: int) -> int:
    f, p = 1, 2
    while n > 1 and p * p <= n:
        while n % p == 0:
            n //= p
            f = p
        p += 1
    return max(f, n)


def cell_air(channels: int, seconds: float, n_cells: int = 8,
             seed: int = 7) -> np.ndarray:
    """A locked TETRA multiplex on every carrier: n_cells distinct cells
    (MCC 262, MNC 100 + i, CC 1 + i; carrier c carries cell c % n_cells),
    per-carrier CFO uniform in +-400 Hz, 25 dB SNR (the recipe of
    scripts/bench_e2e.py build_wideband).  Returns complex64 at
    channels * 25 kHz, about `seconds` long.

    The 50 kHz length T50 is kept 7-smooth: the synthesis FFT has
    T50 * channels/2 points, and one large prime factor there turns
    seconds into minutes."""
    n_slots = int(seconds / 0.014167) + 4
    streams = [downlink_bits(_cell_config(i), n_slots,
                             start=TdmaTime(mn=2, fn=14, tn=1))[0]
               for i in range(n_cells)]
    return _multiplex(streams, channels, seed)


def _cell_config(i: int) -> CellConfig:
    """Cell i of the fixtures' multiplex: MCC 262, MNC 100 + i, CC 1 + i."""
    return CellConfig(mcc=262, mnc=100 + i, cc=1 + i)


def _multiplex(streams: list, channels: int, seed: int) -> np.ndarray:
    """Carrier c carries streams[c % len(streams)], cut to a 7-smooth 50 kHz
    length, per-carrier CFO uniform in +-400 Hz, 25 dB SNR."""
    n_cells = len(streams)
    # synthesize_wideband takes T36 = L - 64 rounded down to 36 k, and
    # T50 = 25 k
    k = (min(len(s) for s in streams) - (P.RRC_TAP_COUNT - 1)) // 36
    while _largest_prime_factor(k) > 7:
        k -= 1
    L = 36 * k + P.RRC_TAP_COUNT - 1
    bitmat = np.stack([streams[c % n_cells][:L] for c in range(channels)])
    cfo = np.random.default_rng(seed).uniform(-400.0, 400.0, channels)
    return synthesize_wideband(bitmat, channels, cfo_hz=cfo, snr_db=25.0,
                               seed=seed)


def cell_air_device(channels: int, seconds: float, n_cells: int = 8,
                    seed: int = 7, device=None):
    """cell_air's recipe built on `device` (the current CUDA device unless
    the caller asks for the CPU), as marginal_air builds its air: carrier
    c carries cell c % n_cells of cell_air at unit power with cell_air's
    CFO draw (uniform in +-400 Hz), modulated at 36 kHz (tx.modulator),
    mixed onto its carrier by assemble_wideband, and the band gets one
    white floor 25 dB under a carrier in its 25 kHz channel
    (tx.channel.add_awgn, noise from a torch.Generator seeded with
    `seed`).  One seed gives one air on one device type.  Returns a
    complex64 tensor of about `seconds` of air on the device."""
    import torch

    from .. import resolve_device
    from .channel import add_awgn, apply_cfo
    from .modulator import modulate

    device = resolve_device(device)
    fs36 = int(P.SAMPLE_RATE)
    n36 = int(seconds * fs36)
    cells = []
    for i in range(n_cells):
        bits, _ = downlink_bits(_cell_config(i), n36 // P.BITS_PER_TS + 2,
                                start=TdmaTime(mn=2, fn=14, tn=1))
        iq = modulate(bits[None], device=device)[0, :n36]
        cells.append(iq / float(torch.mean(iq.abs() ** 2)) ** 0.5)
    cfo = np.random.default_rng(seed).uniform(-400.0, 400.0, channels)
    wide = assemble_wideband(
        {c: apply_cfo(cells[c % n_cells], float(cfo[c]),
                      P.SAMPLE_RATE).cpu().numpy() for c in range(channels)},
        channels, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    return add_awgn(wide, 25.0, gen, signal_power=float(channels),
                    device=device)


def cell_keystore(cells, seed: int = 7) -> str:
    """A text keystore (the format crypto.state.KeyStore.load reads) giving
    each of the fixtures' `cells` a TEA1 network and a seeded 80-bit CCK,
    key number 3."""
    rng = np.random.default_rng(seed)
    lines = ["# TEA1 common cipher keys of the fixture cells"]
    for i in cells:
        cfg = _cell_config(i)
        key = bytes(rng.integers(0, 256, 10, dtype=np.uint8)).hex().upper()
        lines += [f"network mcc {cfg.mcc} mnc {cfg.mnc} ksg_type {KSG_TEA1} "
                  f"security_class 2",
                  f"key mcc {cfg.mcc} mnc {cfg.mnc} addr 0 key_type "
                  f"{KEYTYPE_CCK_SCK} key_num 3 key {key}"]
    return "\n".join(lines) + "\n"


def _tx_crypto(store: KeyStore, cfg: CellConfig) -> CryptoState:
    """The base station's cipher state for cfg: the identity its SYNC and
    SYSINFO PDUs carry, and CCK number 3."""
    cs = CryptoState(store=store)
    cs.cc, cs.la, cs.cn, cs.hn = (cfg.cc, cfg.la, cfg.main_carrier,
                                  cfg.hyperframe)
    cs.cck_id = 3
    cs.update_network(cfg.mcc, cfg.mnc)
    if cs.cck is None:
        raise ValueError(f"keystore has no CCK 3 for MNC {cfg.mnc}")
    return cs


def voice_cell_air(channels: int, seconds: float, n_cells: int = 8,
                   keystore: str | None = None, encrypted=(),
                   seed: int = 7):
    """cell_air's multiplex with traffic: every cell carries voice on
    timeslot 2 (seeded random 2 x 137-bit codec frames), a few stolen slots
    per cell of both kinds (both halves, and the first half only, whose
    second half keeps one speech frame), and the cells in `encrypted` are
    TEA1-encrypted (voice and MAC-RESOURCE SDUs, SYSINFO alternating its
    hyperframe and CCK-id arms) with their CCK from the text keystore at
    path `keystore` (cell_keystore writes one).

    Returns (wide, records): wide as cell_air's, records[i] the
    tx.cell.SlotRecord list of cell i (slot j starts at 36 kHz sample
    510 j of its carrier; "voice" records and the "stch" records of
    first-half steals carry the plaintext frames)."""
    store = KeyStore.load(keystore) if encrypted else None
    n_slots = int(seconds / 0.014167) + 4
    streams, records = [], []
    for i in range(n_cells):
        cfg = _cell_config(i)
        rng = np.random.default_rng(seed * 1000 + i)
        frames = lambda rng=rng: rng.integers(0, 2, (2, 137)).astype(np.uint8)
        stolen = {(3 + i % 5, 2): "first", (10 + i % 6, 2): "both",
                  (16, 2): "first" if i % 2 else "both"}
        # the first SYNC bursts at 0.4 s and 1.4 s of air: an encrypted
        # cell's receiver, locked by the first, learns the hyperframe
        # number from it and the CCK id from the second
        bits, recs = downlink_bits(
            cfg, n_slots, start=TdmaTime(mn=2, fn=11, tn=1),
            payload_rng=np.random.default_rng(seed * 1000 + 500 + i),
            voice_slots={2: frames}, stolen_slots=stolen,
            crypto=_tx_crypto(store, cfg) if i in encrypted else None)
        streams.append(bits)
        records.append(recs)
    return _multiplex(streams, channels, seed), records


def handover_cell(j: int) -> CellConfig:
    """The cell that takes over handover carrier j of marginal_air: a new
    MCC, MNC and colour code, so a new scrambling code."""
    return CellConfig(mcc=901, mnc=40 + j, cc=10 + j)


# marginal_air: the SNR sweep of the carriers that stay (dB per 25 kHz
# channel), and every HANDOVER_EVERY-th carrier at HANDOVER_SNR_DB (the
# level of the reference's handover stream, tests/test_fleet.py:98)
# silent for DROPOUT_S before another cell takes over
MARGINAL_SNR_DB = (7.5, 12.0)
HANDOVER_EVERY = 8
HANDOVER_SNR_DB = 25.0
DROPOUT_S = 0.5


def marginal_air(channels: int, seconds: float, dropout_at: float = 2.0,
                 seed: int = 11, device=None):
    """Carriers at marginal SNR, some dropping out and coming back as
    another cell.  Carrier c carries cell c % 8 of cell_air (MCC 262, MNC
    100 + i, CC 1 + i) at its own SNR and CFO (uniform in +-400 Hz), the
    SNRs spread over MARGINAL_SNR_DB in a seeded order.  Every
    HANDOVER_EVERY-th carrier (c % HANDOVER_EVERY == HANDOVER_EVERY - 1)
    is at HANDOVER_SNR_DB, goes silent at dropout_at for DROPOUT_S, then
    carries handover_cell(j) (j counts those carriers) on a TDMA timeline
    of its own.

    Each carrier is modulated at 36 kHz (tx.modulator), rotated by its CFO
    and scaled to its level (tx.channel), mixed onto its carrier
    (assemble_wideband), and the band gets one white noise floor
    (tx.channel.add_awgn): a carrier's SNR is its power over the noise in
    its 25 kHz channel, as synthesize_wideband sets it, and a carrier in
    its dropout is the floor alone.  (Noise added per carrier at 36
    kHz would overlap the neighbours' 25 kHz channels, unlike thermal
    noise, and bias their band-edge FLLs.)  Everything after the bit
    streams runs on `device` (the current CUDA device unless the caller
    asks for the CPU); one seed gives one air on one device type.

    Returns (wide, plan): wide complex64 at channels * 25 kHz, seconds
    long; plan a dict of per-carrier arrays snr_db, cfo_hz, handover
    (bool), cell (index of the first cell), new_cell (handover_cell
    index, -1 elsewhere), and the dropout's start and end in seconds."""
    import torch

    from .. import resolve_device
    from .channel import add_awgn, apply_cfo
    from .modulator import modulate

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fs36 = int(P.SAMPLE_RATE)
    n36 = int(seconds * fs36)
    drop0, drop1 = int(dropout_at * fs36), int((dropout_at + DROPOUT_S)
                                               * fs36)
    handover = np.arange(channels) % HANDOVER_EVERY == HANDOVER_EVERY - 1
    snr = np.full(channels, HANDOVER_SNR_DB)
    snr[~handover] = rng.permutation(np.linspace(*MARGINAL_SNR_DB,
                                                 int((~handover).sum())))
    cfo = rng.uniform(-400.0, 400.0, channels)
    phase0 = rng.uniform(0.0, 2 * np.pi, channels)
    new_cell = np.where(handover, np.cumsum(handover) - 1, -1)

    def stream(cfg: CellConfig, n: int, start: TdmaTime) -> torch.Tensor:
        bits, _ = downlink_bits(cfg, n // P.BITS_PER_TS + 2, start=start)
        return modulate(bits[None], device=device)[0, :n]

    first = [stream(_cell_config(i), n36, TdmaTime(mn=2, fn=14, tn=1))
             for i in range(8)]
    later = {j: stream(handover_cell(j), n36 - drop1,
                       TdmaTime(mn=9, fn=17, tn=4))
             for j in new_cell[handover]}
    # the strongest carrier at unit power; the floor sets the others' SNR
    top = float(snr.max())
    gain = 10.0 ** ((snr - top) / 20.0) / float(
        torch.mean(first[0].abs() ** 2)) ** 0.5
    carriers = {}
    for c in range(channels):
        iq = first[c % 8]
        if handover[c]:
            iq = torch.cat([iq[:drop0], iq.new_zeros(drop1 - drop0),
                            later[new_cell[c]]])
        carriers[c] = apply_cfo(iq * float(gain[c]), float(cfo[c]),
                                P.SAMPLE_RATE, float(phase0[c])).cpu().numpy()
    wide = assemble_wideband(carriers, channels, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    wide = add_awgn(wide, top, gen, signal_power=float(channels),
                    device=device).cpu().numpy()
    return wide, dict(snr_db=snr, cfo_hz=cfo, handover=handover,
                      cell=np.arange(channels) % 8, new_cell=new_cell,
                      dropout=(drop0 / fs36, drop1 / fs36))


def staged_windows(wide, advance: int, wide_len: int, wb_k: int, device,
                   first: int = 0, count: int | None = None) -> list:
    """Cut wideband air (a complex array, or a complex tensor on any
    device) into superblocks of wb_k overlapping windows, the inputs of
    TetraReceiver.process_wideband_staged: a list of float32 (wb_k,
    wide_len) re/im pairs on `device`, `count` superblocks from
    superblock `first` (all by default)."""
    import torch

    sb_adv = wb_k * advance
    n = (len(wide) - wide_len) // sb_adv
    out = []
    for s in range(first, n if count is None else first + count):
        wins = torch.stack([torch.as_tensor(
            wide[s * sb_adv + j * advance:s * sb_adv + j * advance + wide_len])
            for j in range(wb_k)]).to(device, torch.complex64)
        out.append((wins.real.contiguous(), wins.imag.contiguous()))
    return out


def locked_downlink_iq(n_samples: int) -> np.ndarray:
    """One continuous TETRA downlink stream (complex64, 2 sps)."""
    n_bits = n_samples
    n_slots = -(-n_bits // P.BITS_PER_TS) + 1
    bits, _ = downlink_bits(CellConfig(), n_slots)
    up, h = _shaped(bits[:n_bits])
    ext = np.concatenate([np.zeros(len(h) - 1, np.complex64), up])
    return np.convolve(ext, h, mode="valid").astype(np.complex64)


def heterogeneous_fleet_iq(k: int, channels: int, block: int,
                           seed: int = 2):
    """(k, channels, block) float32 re/im arrays: one locked downlink per
    channel with its own CFO (+-1 kHz), sample-clock ppm (+-100), timing
    phase and SNR (15..30 dB)."""
    rng = np.random.default_rng(seed)
    n = k * block
    margin = 4096
    base = locked_downlink_iq(n + margin)
    xr = np.empty((channels, n), np.float32)
    xi = np.empty((channels, n), np.float32)
    tgrid = np.arange(n, dtype=np.float64)
    cfo = rng.uniform(-1000.0, 1000.0, channels) * (2 * np.pi / 36000.0)
    ppm = rng.uniform(-100.0, 100.0, channels) * 1e-6
    phase0 = rng.uniform(0.0, 2 * np.pi, channels)
    start = rng.uniform(0.0, 510.0, channels)
    snr_db = rng.uniform(15.0, 30.0, channels)
    for c in range(channels):
        tt = start[c] + (1.0 + ppm[c]) * tgrid
        y = np.interp(tt, np.arange(len(base)), base.real) \
            + 1j * np.interp(tt, np.arange(len(base)), base.imag)
        y = y * np.exp(1j * (cfo[c] * tgrid + phase0[c]))
        amp = np.sqrt(np.mean(np.abs(y) ** 2))
        sigma = amp * 10 ** (-snr_db[c] / 20.0) / np.sqrt(2.0)
        xr[c] = y.real + sigma * rng.standard_normal(n)
        xi[c] = y.imag + sigma * rng.standard_normal(n)
    return (xr.reshape(channels, k, block).transpose(1, 0, 2).copy(),
            xi.reshape(channels, k, block).transpose(1, 0, 2).copy())
