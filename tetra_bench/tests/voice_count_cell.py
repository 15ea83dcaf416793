"""A cell module for the harness's tests (copied into a test checkout as
tetra_bench/cells/voice_count.py): it hands the fleet receiver a voice
callback and checks that the receiver passed it every traffic slot of
every occupied carrier, and no other slot.

The fleet calls voice_cb(t, type4) for each full traffic slot and
voice_cb.half(t, type4) for the speech half of a first-half steal, with
the slot's TDMA time and no carrier.  So the calls are counted by period
slot, and set against each carrier's known timeline: the slots it
consumed (its slot count, ending at its last slot's time) and what the
air's records sent in each (a record with "frames": a voice slot; with
"half_frame": a first-half steal).  CALLS logs the module's calls in
order, for the tests.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from tetra_bench.reference.truth import slot_of

CALLS = []


class VoiceCalls:
    """The fleet's voice callback: calls counted by (mn, fn, tn) once
    `start` holds each carrier's (slot count, last slot's time)."""

    def __init__(self):
        self.full, self.halves = Counter(), Counter()
        self.start = None

    def __call__(self, t, type4):
        if self.start is not None:
            self.full[(t.mn, t.fn, t.tn)] += 1

    def half(self, t, type4):
        if self.start is not None:
            self.halves[(t.mn, t.fn, t.tn)] += 1


def _state(ch) -> tuple:
    return int(ch.slot_count), (int(ch.time.mn), int(ch.time.fn),
                                int(ch.time.tn))


def receiver_kwargs(config, traffic, keystore_path):
    keys = None
    if keystore_path is not None:
        with open(keystore_path) as f:
            keys = [line.split() for line in f if line.startswith("key ")]
    CALLS.append(("receiver_kwargs", keys))
    return {"voice_cb": VoiceCalls()}


def attach(rx, air, seed):
    CALLS.append(("attach", seed))
    fleet, calls = rx.fleet, rx.fleet.voice_cb
    occupied = np.nonzero(air.cell_of >= 0)[0]
    step = fleet.process_packed2

    def counted(*args, **kw):
        if calls.start is None and all(fleet.chan(c).cell_mcc
                                       for c in occupied):
            calls.start = [_state(fleet.chan(c))
                           for c in range(rx.channels)]
        return step(*args, **kw)
    fleet.process_packed2 = counted
    return calls


def collect(state, rx):
    CALLS.append(("collect", None))
    return {"full": dict(state.full), "half": dict(state.halves),
            "start": state.start,
            "end": [_state(rx.fleet.chan(c)) for c in range(rx.channels)]}


def checks(data, air, seed, limits):
    CALLS.append(("checks", seed))
    P = air.period_slots
    kinds = {"full": "frames", "half": "half_frame"}
    expected = {k: np.zeros(P, np.int64) for k in kinds}
    if data["start"] is None:
        return [("voice_calls_off", None, limits["voice_calls_off"])]
    for c, cell in enumerate(air.cell_of):
        (s0, t0), (s1, _) = data["start"][c], data["end"][c]
        if cell < 0 or s1 == s0:
            continue
        p0 = int(slot_of(*t0, P)) + 1
        counts = np.bincount((p0 + np.arange(s1 - s0)) % P, minlength=P)
        for k, key in kinds.items():
            sent = np.array([key in rec for rec in air.records[cell]])
            expected[k] += counts * sent
    off = 0
    for k in kinds:
        got = np.zeros(P, np.int64)
        for t, v in data[k].items():
            got[int(slot_of(*t, P))] += v
        off += int(np.abs(got - expected[k]).sum())
    n_expected = int(sum(e.sum() for e in expected.values()))
    return [("voice_calls_off", off if n_expected else None,
             limits["voice_calls_off"])]
