"""The harness's wrappers around the calls into each layer of the
receiver: they count the calls, keep copies of what the timed path
produced for the correctness check, and, in a traced run, time each
layer on the host clock and open a profiler range around it.

Layers and the calls wrapped (the program's module attributes and the
receiver's own methods, restored by close()):

    ingest          TetraReceiver.process_wideband (host feed)
    superblock      TetraReceiver._superblock
    step            rx.receiver._wideband_step_scan
    frontend        parallel.channelizer._front_end_block      (K3)
    demod           rx.demod_fast._demod_block_impl            (K1, K2)
    engine          FleetEngine.process_packed2
    fec             rx.fec.decode_rows_typed_packed
    dispatch        the engine's native fleet_dispatch: every decoded
                    block with its CRC verdict on its way to the MAC, and
                    the TDMA time the MAC stamped it with
"""

from __future__ import annotations

import ctypes
import time
from collections import defaultdict

import numpy as np
import torch

T1P_BYTES, META_COLS = 34, 12


class _LibProxy:
    """The engine's native library with fleet_dispatch observed."""

    def __init__(self, lib, probes):
        self._lib, self._probes = lib, probes

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def fleet_dispatch(self, h, t1p, ok, meta, n, voice, half, actions,
                       times):
        out = self._lib.fleet_dispatch(h, t1p, ok, meta, n, voice, half,
                                       actions, times)
        if self._probes.keep_rows and n:
            self._probes.keep_dispatch(t1p, ok, meta, times, int(n))
        return out


def _view(addr: int, ctype, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctype * count).from_address(addr))


class Probes:
    """Installs the wrappers on one receiver.  cycles/steps count the
    front-end calls and superblock steps since the receiver was built;
    capture_cycles and capture_steps name those whose outputs are kept
    (front end, demod; decoded blocks)."""

    def __init__(self, rx, timed: bool):
        from tetra_tpu_torch.parallel import channelizer
        from tetra_tpu_torch.rx import demod_fast, fec, receiver
        self.timed = timed
        self.cycles = self.demod_calls = self.steps = 0
        self.capture_cycles: set = set()
        self.capture_steps: set = set()
        self.frontend: dict = {}
        self.demod: dict = {}
        self.rows: dict = {}
        self.keep_rows = False
        self.host_s: dict = defaultdict(float)
        self.calls: dict = defaultdict(int)
        self._restore = []
        self._patch(channelizer, "_front_end_block", "frontend",
                    self._after_frontend)
        self._patch(demod_fast, "_demod_block_impl", "demod",
                    self._after_demod)
        self._patch(receiver, "_wideband_step_scan", "step", None,
                    before=self._before_step)
        self._patch(fec, "decode_rows_typed_packed", "fec", None)
        self._patch(rx.fleet, "process_packed2", "engine", None)
        self._patch(rx, "_superblock", "superblock", None)
        self._patch(rx, "process_wideband", "ingest", None)
        lib = rx.fleet.lib
        rx.fleet.lib = _LibProxy(lib, self)
        self._restore.append((rx.fleet, "lib", lib))

    def _patch(self, owner, name, label, after, before=None):
        fn = getattr(owner, name)
        self._restore.append((owner, name, fn))
        probes = self

        def wrapper(*args, **kw):
            if before is not None:
                before()
            if probes.timed:
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench." + label):
                    out = fn(*args, **kw)
                probes.host_s[label] += time.perf_counter() - t0
            else:
                out = fn(*args, **kw)
            probes.calls[label] += 1
            if after is not None:
                after(out)
            return out

        setattr(owner, name, wrapper)

    def close(self) -> None:
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore = []

    # -- captures ----------------------------------------------------------

    def _before_step(self) -> None:
        self.keep_rows = self.steps in self.capture_steps
        self.step_index = self.steps
        self.steps += 1

    def _after_frontend(self, out) -> None:
        if self.cycles in self.capture_cycles:
            self.frontend[self.cycles] = (out[0].clone(), out[1].clone())
        self.cycles += 1

    def _after_demod(self, out) -> None:
        outs = out[1]
        if self.demod_calls in self.capture_cycles and "dibits_tc" in outs:
            self.demod[self.demod_calls] = (outs["dibits_tc"].clone(),
                                            outs["valid_tc"].clone())
        self.demod_calls += 1

    def keep_dispatch(self, t1p: int, ok: int, meta: int, times: int,
                      n: int) -> None:
        """A dispatch's rows: channel, block type and number from the
        engine's row metadata, the TDMA time the MAC gave each row
        (hn, mn, fn, tn, sn), the CRC verdict and the type-1 bits."""
        m = _view(meta, ctypes.c_int64, n * META_COLS).reshape(n, META_COLS)
        t = _view(times, ctypes.c_int64, n * 5).reshape(n, 5)
        rows = dict(chan=m[:, 0].copy(), btype=m[:, 1].copy(),
                    bnum=m[:, 2].copy(), mn=t[:, 1].copy(),
                    fn=t[:, 2].copy(), tn=t[:, 3].copy(),
                    ok=_view(ok, ctypes.c_uint8, n).astype(bool),
                    type1=_view(t1p, ctypes.c_uint8,
                                n * T1P_BYTES).reshape(n, T1P_BYTES).copy())
        self.rows.setdefault(self.step_index, []).append(rows)

    # -- host-clock spans ----------------------------------------------------

    def take(self) -> tuple[dict, dict]:
        """Host seconds and calls per layer since the last take."""
        s, c = dict(self.host_s), dict(self.calls)
        self.host_s.clear()
        self.calls.clear()
        return s, c
