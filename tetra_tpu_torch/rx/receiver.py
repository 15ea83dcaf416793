"""Multi-channel TETRA receiver, fleet modes (port of
tetra_tpu/rx/receiver.py).

Ported: the wideband fleet receiver (wideband=N, fleet=True: front end K3
+ demod K1/K2 per cycle, K cycles per superblock packed into the
fleet-feed words, native burst sync + MAC, batched FEC) and the narrowband
fleet receiver (fleet=True: demod K1/K2 per block).  Other modes raise
NotImplementedError (ROADMAP Queue 1 items 9-13).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..parallel import channelizer as CH
from . import demod_fast
from .fleet import FleetEngine


def pack_cycle_tc(dib_tc, v32, dist_tc, n_ch: int, n_chunks: int):
    """Pack ONE demod cycle's time-major outputs into the fleet-feed rows
    (sym_words + cnt_words, C) int32:

      * symbol rows: 16 consecutive symbol slots per int32, 2-bit dibit
        fields, lowest bits first (the top field wraps into the sign bit);
      * count rows: per K_SYM-symbol chunk the valid-symbol count (validity
        is a prefix within each chunk), 4 chunk counts per int32.

    Also returns the per-channel valid count and the dist sum over valid
    slots (float32) for the quality rows."""
    Ks = demod_fast.K_SYM
    Tp = n_chunks * Ks
    dev = dib_tc.device
    w = (dib_tc & 3).to(torch.int64).reshape(Tp // 16, 16, n_ch)
    sh2 = (torch.arange(16, device=dev) * 2)[None, :, None]
    sym64 = (w << sh2).sum(dim=1)               # disjoint fields: sum == OR
    # two's-complement wrap into int32, as the reference's int32 sum does
    sym_rows = torch.where(sym64 >= 2 ** 31, sym64 - 2 ** 32,
                           sym64).to(torch.int32)
    counts = v32.to(torch.int64).reshape(n_chunks, Ks, n_ch).sum(dim=1)
    cnt_words = -(-n_chunks // 4)
    pad = cnt_words * 4 - n_chunks
    if pad:
        counts = torch.cat([counts, counts.new_zeros((pad, n_ch))], dim=0)
    sh8 = (torch.arange(4, device=dev) * 8)[None, :, None]
    cnt_rows = (counts.reshape(cnt_words, 4, n_ch) << sh8).sum(dim=1).to(
        torch.int32)
    packed = torch.cat([sym_rows, cnt_rows], dim=0)
    vacc_inc = v32.sum(dim=0).to(torch.float32)
    dacc_inc = torch.where(v32.bool(), dist_tc, 0.0).sum(dim=0)
    return packed, vacc_inc, dacc_inc


def _wideband_step_scan(dstate, wrk, wik, hr, hi, n_ch: int, t36: int,
                        n_chunks: int, i16: bool, kw: int):
    """K-cycle superblock: kw overlapping windows (kw, wide_len) each run
    the front end + demod; returns ONE int32 (kw*G + 2, C) array in the
    pack_cycle_tc layout, whose last two rows carry the float32 bits of the
    per-channel valid count and dist sum."""
    zero = torch.zeros(n_ch, dtype=torch.float32, device=wrk.device)
    vacc, dacc = zero, zero
    packed_k = []
    for j in range(kw):
        wr, wi = wrk[j], wik[j]
        if i16:
            # cs16 converts on the device (half the upload bytes)
            wr = wr.to(torch.float32) * (1.0 / 32768.0)
            wi = wi.to(torch.float32) * (1.0 / 32768.0)
        rr, ri, hr, hi = CH._front_end_block(wr, wi, hr, hi, n_ch, t36)
        dstate, outs = demod_fast._demod_block_impl(dstate, rr.T, ri.T,
                                                    n_chunks, tc_out=True)
        packed, vinc, dinc = pack_cycle_tc(
            outs["dibits_tc"], outs["valid_tc"], outs["dist_tc"], n_ch,
            n_chunks)
        packed_k.append(packed)
        vacc = vacc + vinc
        dacc = dacc + dinc
    out = torch.cat(packed_k + [vacc.view(torch.int32)[None],
                                dacc.view(torch.int32)[None]], dim=0)
    return dstate, out, hr, hi


class TetraReceiver:
    def __init__(self, channels: int = 1, voice_cb=None, mode: str = "fast",
                 wideband: int = 0, t50: int = 6400, fleet: bool = False,
                 wb_k: int = 1, device=None):
        """fleet=True runs the whole bit pipeline in the native fleet
        engine (rx/fleet.FleetEngine).  wideband=N > 0 makes this an
        N x 25 kHz wideband receiver fed through process_wideband() or
        process_wideband_staged(); channels is forced to N, t50 sets the
        per-channel 50 kHz samples per internal block (t50*18/25 must be a
        multiple of the demod chunk), and wb_k cycles run per superblock.
        device: the torch device everything runs on: the current CUDA
        device by default, "cpu" only when asked for (resolve_device)."""
        if not fleet:
            raise NotImplementedError(
                "only the fleet receiver is ported: the per-channel "
                "LowerMac/BurstSync modes are ROADMAP Queue 1 item 9")
        if mode != "fast":
            raise NotImplementedError(
                f"mode={mode!r}: only the chunked 'fast' chain is ported "
                f"(ROADMAP Queue 1 items 11 and 13)")
        self.device = resolve_device(device)
        if wideband:
            channels = wideband
        self.channels = channels
        self.demod = demod_fast
        self.state = demod_fast.demod_init(channels, self.device)
        self.fleet = FleetEngine(channels, self.device, voice_cb=voice_cb)
        self.sym_quality = np.zeros(channels, np.float32)
        self.wideband = wideband
        self.wb_k = max(1, wb_k)
        if wideband:
            self._init_wideband(t50)
        else:
            self._cfo_primed = False

    def _init_wideband(self, t50: int):
        t36 = t50 * 18 // 25
        if t50 % 25 or t36 % demod_fast.K_SAMP:
            raise ValueError("t50*18/25 must be a multiple of the demod "
                             "chunk")
        hop = self.wideband // 2
        L = self.wideband * CH.TAPS_PER_BRANCH
        pad = CH.RS_TAPS_PER_PHASE - 1
        z = lambda: torch.zeros((pad, self.channels), dtype=torch.float32,
                                device=self.device)
        self._wb = dict(
            t50=t50, t36=t36, hop=hop, L=L,
            wide_len=(t50 - 1) * hop + L, advance=t50 * hop,
            n_chunks=demod_fast.n_chunks_for(t36),
            buf=np.zeros(0, np.complex64), hist_r=z(), hist_i=z())
        # the fused front end never exposes per-channel IQ for a coarse CFO
        # preset; the FLL pulls in from zero
        self._cfo_primed = True

    @staticmethod
    def coarse_cfo(iq: np.ndarray) -> np.ndarray:
        """Coarse CFO per channel, rad/sample: angle(mean z^4) = 8w + pi
        with z = x[n] conj(x[n-2]) (pi/4-DQPSK), |CFO| < fs/16."""
        zr = (iq[:, 2:] * np.conj(iq[:, :-2]))
        z4 = (zr * zr) ** 2
        ang = np.angle(z4.mean(axis=1))
        w = (ang - np.pi + np.pi) % (2 * np.pi) - np.pi
        return (w / 8.0).astype(np.float32)

    def process(self, iq: np.ndarray) -> None:
        """Feed one (C, T) IQ block at 36 ksps per channel (narrowband)."""
        iq = np.atleast_2d(iq)
        if iq.shape[0] != self.channels:
            raise ValueError(f"{iq.shape[0]} channels fed to a "
                             f"{self.channels}-channel receiver")
        if not self._cfo_primed:
            # one-shot acquisition assist: preset the FLL frequency
            self._cfo_primed = True
            est = self.coarse_cfo(np.asarray(iq, np.complex64))
            self.state = self.state._replace(
                fll_freq=torch.from_numpy(est).to(self.device))
        self.state, outs = demod_fast.demod_block(self.state, iq)
        valid = outs["valid"].cpu().numpy()
        dist = outs["dist"].cpu().numpy()
        cnt = valid.sum(axis=1)
        nz = cnt > 0
        if nz.any():
            s = np.where(valid, dist, 0.0).sum(axis=1)
            self.sym_quality[nz] = (s[nz] / cnt[nz]).astype(np.float32)
        self.fleet.process(outs["dibits"].cpu().numpy(),
                           valid.astype(np.uint8))

    def process_wideband(self, raw: np.ndarray) -> None:
        """Feed raw wideband IQ at N*25 kHz (complex, or interleaved cs16
        int16; any length, buffered internally).  Every wb_k full windows
        run as one superblock."""
        if not self.wideband:
            raise ValueError("construct with wideband=N")
        wb = self._wb
        raw = np.asarray(raw)
        i16 = raw.dtype == np.int16
        if i16:
            if wb["buf"].dtype != np.int16:
                if len(wb["buf"]):
                    raise ValueError("cannot mix cs16 and cf32 feeds")
                wb["buf"] = np.zeros(0, np.int16)
            if len(raw) % 2:
                raise ValueError("cs16 feed must be whole I/Q pairs")
            wb["buf"] = np.concatenate([wb["buf"], raw])
        else:
            wb["buf"] = np.concatenate([wb["buf"],
                                        np.asarray(raw, np.complex64)])
        stride = 2 if i16 else 1
        K = self.wb_k
        need = stride * ((K - 1) * wb["advance"] + wb["wide_len"])
        while len(wb["buf"]) >= need:
            wins = [wb["buf"][stride * j * wb["advance"]:
                              stride * (j * wb["advance"] + wb["wide_len"])]
                    for j in range(K)]
            if i16:
                wr = np.stack([w[0::2] for w in wins])
                wi = np.stack([w[1::2] for w in wins])
            else:
                wr = np.stack([w.real for w in wins]).astype(np.float32)
                wi = np.stack([w.imag for w in wins]).astype(np.float32)
            wb["buf"] = wb["buf"][stride * K * wb["advance"]:]
            self._superblock(torch.from_numpy(wr).to(self.device),
                             torch.from_numpy(wi).to(self.device), i16)

    def process_wideband_staged(self, wr, wi) -> None:
        """Superblock feed from windows already on the device: wr/wi
        (wb_k, wide_len) float32, window j covering wide samples
        [j*advance, j*advance + wide_len) of the stream (the framing
        process_wideband uses)."""
        if not self.wideband:
            raise ValueError("staged ingest needs wideband=N")
        shape = (self.wb_k, self._wb["wide_len"])
        if tuple(wr.shape) != shape or tuple(wi.shape) != shape:
            raise ValueError(f"staged windows must be {shape}")
        self._superblock(wr, wi, False)

    def _superblock(self, wr, wi, i16: bool) -> None:
        wb = self._wb
        (self.state, fused, wb["hist_r"], wb["hist_i"]) = _wideband_step_scan(
            self.state, wr, wi, wb["hist_r"], wb["hist_i"], self.wideband,
            wb["t36"], wb["n_chunks"], i16, self.wb_k)
        fused = fused.cpu().numpy()
        vcount = fused[-2].view(np.float32)
        dsum = fused[-1].view(np.float32)
        nz = vcount > 0
        if nz.any():
            self.sym_quality[nz] = (dsum[nz] / vcount[nz]).astype(np.float32)
        self.fleet.process_packed2(fused[:-2], self.wb_k, wb["n_chunks"])

    def flush_wideband(self) -> None:
        """Nothing is deferred: every superblock is decoded when it is fed
        (kept so reference callers run unchanged)."""

    # -- views ---------------------------------------------------------------

    def display(self, c: int = 0):
        return self.fleet.display(c)

    def locked(self, c: int = 0) -> bool:
        return self.fleet.locked(c)

    def crc_counts(self, c: int = 0) -> tuple[int, int]:
        return self.fleet.crc_counts(c)

    # -- checkpoint / resume (the reference's fleet-mode npz keys) -----------

    def save_state(self, path: str) -> None:
        data = {f"demod_{k}": v.cpu().numpy()
                for k, v in self.state._asdict().items()}
        data["fleet_blob"] = np.frombuffer(self.fleet.state_bytes(), np.uint8)
        data["sym_quality"] = self.sym_quality
        if self.wideband:
            data["wb_buf"] = self._wb["buf"]
            data["wb_hist_r"] = self._wb["hist_r"].cpu().numpy()
            data["wb_hist_i"] = self._wb["hist_i"].cpu().numpy()
        np.savez(path, **data)

    def load_state(self, path: str) -> None:
        from ..convert import hist_from_numpy, state_from_numpy
        z = np.load(path)
        if "fleet_blob" not in z.files:
            raise ValueError("not a fleet-mode checkpoint")
        self.state = state_from_numpy(
            {k[len("demod_"):]: z[k] for k in z.files
             if k.startswith("demod_")}, self.device)
        self.fleet.load_state_bytes(z["fleet_blob"].tobytes())
        self.sym_quality = z["sym_quality"]
        if self.wideband and "wb_hist_r" in z.files:
            self._wb["buf"] = z["wb_buf"].astype(np.complex64) \
                if z["wb_buf"].dtype != np.int16 else z["wb_buf"]
            self._wb["hist_r"], self._wb["hist_i"] = hist_from_numpy(
                z["wb_hist_r"], z["wb_hist_i"], self.device)
        self._cfo_primed = True
