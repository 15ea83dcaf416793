"""The voice monitor's cell: every call's speech, decrypted where the keys
are held, against the air's plaintext.

The receiver is built with voice=True and the configuration's keystore,
so the fleet engine decodes every voice slot of every carrier each
superblock (the program's voice monitor) and hands the superblock's
arrays out through rx.take_voice().  attach() wraps the engine's
superblock call: before the window's first superblock it notes each
carrier's slot count and last slot's time, and after every superblock it
keeps the references take_voice() returns (the PCM only of the
window's first PCM_FROM superblocks); it decodes nothing, and the
program's voice work counts in rt_carriers.  The checks then hold what
was kept against the air:

- voice_slots_missed: per carrier, the voice slots and surviving halves
  the air sent in the slots the carrier consumed from the window's start
  to the run's end (its slot counts, each slot's place in the period
  from the time noted at the window's start), less those delivered once;
- voice_frames_wrong: the window's delivered codec frames against the
  air's plaintext `frames` (a half: frame 2 against `half_frame`), bit
  for bit, in the slot the carrier's slot count places them; a frame
  flagged bad, a frame of a slot that sent no voice, a kind that differs
  from the slot's and a stamp that is not the slot's time count as wrong;
- voice_pcm_err: the PCM of every call in PCM_SUPERBLOCKS superblocks
  drawn from the seed among the window's first PCM_FROM (all of them in
  a window that holds fewer), against the reference's synthesis
  (reference/voice.py) of that call's frames from its first synthesised
  slot (its first slot not withheld): in the warm-up the frames and
  bad-frame flags it was delivered, in order, and from the window's
  start the air's plaintext frames of its voice slots; the largest
  absolute difference, in LSB.  The warm-up is judged by no check (a
  carrier still settling there may deliver a class-0 bit wrong, which no
  CRC covers, or lose its lock and find it again), but its frames are in
  the decoder's state.  Calls alike in both parts are synthesised once.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from tetra_bench.reference import truth
from tetra_bench.reference import voice as RV

PCM_SUPERBLOCKS = 4
PCM_FROM = 6
WITHHELD = 2                # VoiceBlock.crypt of a slot not synthesised
HALF = 1                    # VoiceBlock.kind of a surviving half

_RUN: dict = {}


def receiver_kwargs(config, traffic, keystore_path):
    _RUN["warmup_s"] = traffic["warmup_s"]
    return {"voice": True, "keystore": keystore_path}


def _snapshot(fleet, C: int) -> list:
    return [(int(fleet.chan(c).slot_count),
             (int(fleet.chan(c).time.mn), int(fleet.chan(c).time.fn),
              int(fleet.chan(c).time.tn))) for c in range(C)]


class _Kept:
    def __init__(self, n_warm: int):
        self.n_warm = n_warm
        self.blocks: list = []          # (superblock, VoiceBlock)
        self.start = None
        self.sb = 0


def attach(rx, air, seed):
    sb_air = rx.wb_k * rx._wb["advance"] / air.fs
    n_warm = math.ceil(_RUN["warmup_s"] / sb_air)
    kept = _Kept(n_warm)
    fleet, step = rx.fleet, rx.fleet.process_packed2

    def superblock(*args, **kw):
        if kept.sb == kept.n_warm:
            kept.start = _snapshot(fleet, rx.channels)
        out = step(*args, **kw)
        for blk in rx.take_voice():
            if not n_warm <= kept.sb < n_warm + PCM_FROM:
                blk.pcm = None
            kept.blocks.append((kept.sb, blk))
        kept.sb += 1
        return out
    fleet.process_packed2 = superblock
    return kept


def collect(state, rx):
    return {"blocks": state.blocks, "start": state.start,
            "end": _snapshot(rx.fleet, rx.channels),
            "n_warm": state.n_warm, "dropped": rx.fleet.voice.dropped}


def _tables(air):
    """Per cell and period slot: the kind of voice the air sent (-1 none,
    0 two frames, 1 a surviving half) and its (2, 137) plaintext frames (a
    half's in frame 2)."""
    n_cells, P = len(air.records), air.period_slots
    kind = np.full((n_cells, P), -1, np.int64)
    plain = np.zeros((n_cells, P, 2, RV.FRAME_BITS), np.uint8)
    for i, recs in enumerate(air.records):
        for p, rec in enumerate(recs):
            if "frames" in rec:
                kind[i, p] = 0
                plain[i, p] = rec["frames"]
            elif "half_frame" in rec:
                kind[i, p] = HALF
                plain[i, p, 1] = rec["half_frame"]
    return kind, plain


def checks(data, air, seed, limits):
    t0 = time.perf_counter()
    names = ("voice_slots_missed", "voice_frames_wrong", "voice_pcm_err")
    if data["start"] is None or not data["blocks"] or data["dropped"]:
        return [(n, None, limits[n]) for n in names]
    P = air.period_slots
    C = len(air.cell_of)
    cell_of = np.asarray(air.cell_of)
    kind_tab, plain = _tables(air)
    p0 = np.array([int(truth.slot_of(*t, P)) for _, t in data["start"]])
    s0 = np.array([s for s, _ in data["start"]], np.int64)
    s_end = np.array([s for s, _ in data["end"]], np.int64)

    # -- the window's deliveries: slots and frames -------------------------
    wrong = 0
    got = []                    # carrier * 2**40 + slot of each delivery
    for sb, blk in data["blocks"]:
        if sb < data["n_warm"] or not len(blk):
            continue
        c, s = blk.carrier, blk.slot
        got.append(c * (1 << 40) + s)
        cell = cell_of[c]
        p = (p0[c] + s - s0[c]) % P
        sent = np.where(cell >= 0, kind_tab[np.maximum(cell, 0), p], -1)
        stamp = truth.slot_of(blk.time[:, 1], blk.time[:, 2],
                              blk.time[:, 3], P)
        n_fr = np.where(blk.kind == HALF, 1, 2)
        off = (sent != blk.kind) | (stamp != p)
        bad = (blk.frames != plain[np.maximum(cell, 0), p]).any(axis=2) \
            | blk.bfi
        bad[blk.kind == HALF, 0] = False
        wrong += int(n_fr[off].sum()) + int(bad[~off].sum())
    got = np.concatenate(got) if got else np.zeros(0, np.int64)
    keys, counts = np.unique(got, return_counts=True)
    wrong += int(2 * (counts - 1).sum())        # delivered more than once
    missed = 0
    for c in np.nonzero(cell_of >= 0)[0]:
        slots = np.arange(s0[c] + 1, s_end[c] + 1)
        voice = kind_tab[cell_of[c], (p0[c] + slots - s0[c]) % P] >= 0
        want = c * (1 << 40) + slots[voice]
        at = np.minimum(np.searchsorted(keys, want), max(len(keys) - 1, 0))
        missed += int((keys[at] != want).sum()) if len(keys) else len(want)

    # -- PCM of the picked superblocks ---------------------------------------
    kept = sorted({sb for sb, blk in data["blocks"] if blk.pcm is not None})
    picks = set(np.random.default_rng([seed, 300]).choice(
        kept, min(PCM_SUPERBLOCKS, len(kept)), replace=False).tolist())
    warm: dict = {}             # call -> its rows synthesised in the warm-up
    rows: dict = {}             # call -> [(slot, pcm)] of the picked
    for sb, blk in data["blocks"]:
        live = blk.crypt != WITHHELD
        call = blk.carrier * 4 + blk.timeslot - 1
        for i in np.nonzero(live)[0]:
            if sb < data["n_warm"]:
                warm.setdefault(int(call[i]), []).append(
                    (int(blk.slot[i]), blk.frames[i], blk.bfi[i],
                     bool(blk.kind[i] == HALF)))
            elif sb in picks:
                rows.setdefault(int(call[i]), []).append(
                    (int(blk.slot[i]), blk.pcm[i]))
    # a call's frames: those it was delivered in the warm-up, in order,
    # then the air's plaintext in each of its voice slots from the
    # window's start; calls alike in both are synthesised once
    groups: dict = {}
    for call in rows:
        c, tn = call // 4, call % 4 + 1
        s_first = int(s0[c] + 1 + (tn - 1 - (p0[c] + 1)) % 4)
        before = warm.get(call, [])
        key = (int(cell_of[c]), int((p0[c] + s_first - s0[c]) % P),
               b"".join(fr.tobytes() + bad.tobytes() + bytes([half])
                        for _, fr, bad, half in before))
        groups.setdefault(key, []).append((call, s_first))
    seqs, index = [], []
    for (cell, q0, _), calls in groups.items():
        call0 = calls[0][0]
        items = [(fr, bad, half) for _, fr, bad, half in warm.get(call0, [])]
        span = max(s - s_first for call, s_first in calls
                   for s, _ in rows[call])
        at = {}
        for k in range(0, span + 1, 4):
            q = (q0 + k) % P
            if kind_tab[cell, q] >= 0:
                at[k] = len(items)
                items.append((plain[cell, q], np.zeros(2, bool),
                              kind_tab[cell, q] == HALF))
        seqs.append(items)
        index.append((calls, at))
    t_pcm = time.perf_counter()
    err = None
    for out, (calls, at) in zip(RV.synthesize(seqs), index):
        for call, s_first in calls:
            for s, pcm in rows[call]:
                k = at.get(s - s_first)
                e = 1 << 16 if k is None else int(np.abs(
                    out[k].astype(np.int64) - pcm).max())
                err = e if err is None else max(err, e)
    print(f"voice checks s: slots and frames {t_pcm - t0:.1f}, PCM "
          f"{time.perf_counter() - t_pcm:.1f} ({len(seqs)} syntheses of "
          f"{max(map(len, seqs), default=0)} slots at most)", file=sys.stderr)
    return [("voice_slots_missed", missed, limits["voice_slots_missed"]),
            ("voice_frames_wrong", wrong, limits["voice_frames_wrong"]),
            ("voice_pcm_err", err, limits["voice_pcm_err"])]
