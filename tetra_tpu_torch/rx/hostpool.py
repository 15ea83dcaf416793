"""Multiprocess host-MAC pool: PDU dispatch sharded across CPU cores (port
of tetra_tpu/rx/hostpool.py).

Once the demod and the FEC run on the card, the host-side stack is the
scale limit: the Python upper-MAC dispatch (PDU parsing, fragment state,
LLC/MLE, voice gating) costs about one core per ~200 real-time channels,
and a voice channel's speech decode far more.  The pool shards exactly
that stage across worker processes while the batched FEC stays in the
parent (one call per batch on the parent's device,
rx/lower_mac.decode_bursts_multi):

    parent:  burst sync (stamping via PhyState) -> decode_bursts_multi
             -> ship (items, decoded, burst stamps) to the owning worker
    worker:  LowerMac._dispatch_decoded per channel (upper MAC, fragments,
             LLC/MLE, voice channel decode + ACELP) -> reply with the phy
             resync, display snapshot, counters, events, voice PCM

Exact-parity design: the worker owns the full LowerMac for its channels;
the parent applies the worker's phy (TDMA time) reply before the next
burst-sync feed, which reproduces the single-process resync sequencing
bit for bit.  Channels are assigned round-robin; replies are collected
synchronously per batch so ordering-sensitive state never races.

Workers run on the CPU: each builds LowerMac(device="cpu") and
VoicePipeline(device="cpu"), as the reference pins its workers to the CPU
backend.  Dispatch is host logic, and a voice slot's channel decode runs
on the worker's own cores; this is the design, not a fallback, and a
worker never opens a CUDA context.  Workers start by `spawn` (a forked
child of a process that has initialised CUDA is unusable), and everything
sent over the pipes is numpy or plain Python values.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from dataclasses import dataclass, field

import numpy as np

from .. import resolve_device


def _phy_save(phy) -> tuple:
    t = phy.time
    return (phy.slot_count, t.hn, t.mn, t.fn, t.tn, t.sn)


def _phy_load(phy, snap: tuple) -> None:
    phy.slot_count, t = snap[0], phy.time
    t.hn, t.mn, t.fn, t.tn, t.sn = snap[1:]


_EMPTY_BITS = np.zeros(0, np.uint8)


def _worker_main(conn, channel_ids, voice: bool, keystore: str | None,
                 events: bool = True):
    """Worker process: owns LowerMac (+ optional voice pipeline) per
    channel, all on the CPU.  A failure is sent back as ("error",
    traceback) and ends the worker; ("ready",) reports it started."""
    from .burst_sync import Burst
    from .lower_mac import LowerMac
    from .tdma import PhyState

    try:
        macs, voices = {}, {}
        for cid in channel_ids:
            m = LowerMac(phy=PhyState(), device="cpu")
            m.upper.events_enabled = events
            if keystore:
                from ..crypto.state import CryptoState, KeyStore
                m.upper.crypto_state = CryptoState(KeyStore.load(keystore))
            if voice:
                from ..voice.pipeline import VoicePipeline
                voices[cid] = m.voice_cb = VoicePipeline(device="cpu")
                # the voice pipeline shares the channel's crypto state so
                # encrypted traffic decodes (decrypt_voice_bits)
                voices[cid].crypto_state = m.upper.crypto_state
            macs[cid] = m
        sent_events = {cid: 0 for cid in channel_ids}
        conn.send(("ready",))

        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                conn.send(("bye",))
                return
            replies = []
            for cid, phy_snap, scramb, items, decoded, burst_descs in msg[1]:
                m = macs[cid]
                _phy_load(m.phy, phy_snap)
                m.cell.scramb_init = scramb
                bursts = [Burst(train_seq=ts, bits=_EMPTY_BITS, time=t,
                                slot_index=si) for ts, t, si in burst_descs]
                m._dispatch_decoded(items, decoded, bursts)
                ev = m.upper.events
                new_events = ev[sent_events[cid]:]
                sent_events[cid] = len(ev)
                pcm = b""
                if cid in voices:
                    pcm = voices[cid].take_audio().tobytes()
                replies.append((cid, _phy_save(m.phy),
                                m.upper.display.as_dict(),
                                m.crc_oks, m.crc_fails, new_events, pcm))
            conn.send(("ok", replies))
    except Exception:
        conn.send(("error", traceback.format_exc()))


@dataclass
class ChannelView:
    """Parent-side snapshot of one pooled channel's MAC state."""
    display: dict = field(default_factory=dict)
    crc_oks: int = 0
    crc_fails: int = 0
    events: list = field(default_factory=list)


class MacPool:
    """Shard the host MAC dispatch of `channels` channels over `workers`
    processes.  Use process_bursts(phys, chan_ids, bursts_list) per demod
    block; channel c is owned by worker c % workers.  device: where the
    parent's batched FEC runs (the current CUDA device unless the caller
    asks for the CPU)."""

    def __init__(self, channels: int, workers: int = 2, voice: bool = False,
                 keystore: str | None = None, events: bool = True,
                 device=None):
        from . import native_mac
        from .lower_mac import CellData

        self.device = resolve_device(device)
        self.channels = channels
        self.workers = max(1, workers)
        self.cells = [CellData() for _ in range(channels)]
        self.views = [ChannelView() for _ in range(channels)]
        self.voice = voice
        self._pcm: list[bytes] = []
        # build the native libraries the workers load here, once, rather
        # than in W workers at once on first use
        native_mac.load()
        if voice:
            from ..voice.acelp import _load
            _load()
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for w in range(self.workers):
            owned = [c for c in range(channels) if c % self.workers == w]
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_worker_main,
                               args=(child_conn, owned, voice, keystore,
                                     events),
                               daemon=True)
            proc.start()
            child_conn.close()
            self._conns.append(parent_conn)
            self._procs.append(proc)
        # every worker has built its MACs (and read the keystore) before
        # the pool is used; a worker that failed to start raises here
        for w in range(self.workers):
            self._recv(w)

    def _recv(self, w: int) -> tuple:
        msg = self._conns[w].recv()
        if msg[0] == "error":
            raise RuntimeError(f"MAC pool worker {w} failed:\n{msg[1]}")
        return msg

    def process_bursts(self, phys: list, chan_ids: list[int],
                       bursts_list: list[list]) -> None:
        """Decode (batched, on the parent's device) + dispatch (workers) one
        batch.

        phys: the parent PhyState per entry (shared with burst sync);
        updated in place from the workers' replies before returning.
        """
        from .lower_mac import decode_bursts_multi

        cells = [self.cells[c] for c in chan_ids]
        all_items, decoded = decode_bursts_multi(cells, bursts_list,
                                                 self.device)
        per_worker: dict[int, list] = {}
        for mi, cid in enumerate(chan_ids):
            if not all_items[mi]:
                continue
            dec = {i: decoded[(mi, i)] for i in range(len(all_items[mi]))}
            descs = [(b.train_seq, b.time, b.slot_index)
                     for b in bursts_list[mi]]
            per_worker.setdefault(cid % self.workers, []).append(
                (cid, _phy_save(phys[mi]), self.cells[cid].scramb_init,
                 all_items[mi], dec, descs))
        for w, batch in per_worker.items():
            self._conns[w].send(("batch", batch))
        phy_by_cid = {cid: phys[mi] for mi, cid in enumerate(chan_ids)}
        for w in per_worker:
            _, replies = self._recv(w)
            for cid, phy_snap, disp, oks, fails, events, pcm in replies:
                _phy_load(phy_by_cid[cid], phy_snap)
                v = self.views[cid]
                v.display, v.crc_oks, v.crc_fails = disp, oks, fails
                v.events.extend(events)
                if pcm:
                    self._pcm.append(pcm)

    def take_audio(self) -> np.ndarray:
        """Drained PCM (s16 @ 8 kHz) from all voice channels, batch order."""
        if not self._pcm:
            return np.zeros(0, np.int16)
        out = np.frombuffer(b"".join(self._pcm), np.int16)
        self._pcm.clear()
        return out

    def close(self) -> None:
        """Stop the workers (each answers "bye") and join them; a worker
        that has already died is joined all the same."""
        for conn, proc in zip(self._conns, self._procs):
            try:
                conn.send(("stop",))
                conn.recv()
            except (OSError, EOFError):
                pass
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()
        self._conns, self._procs = [], []

    def __del__(self):
        try:
            if getattr(self, "_procs", None):
                self.close()
        except Exception:
            pass  # interpreter shutdown: the workers are daemonic anyway
