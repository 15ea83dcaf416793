"""The receiver's answers against what the air carried.

The air is the benchmark's own (tetra_bench.air): every carrier's sent
dibits and every block's type-1 bits are known exactly, so the demod's
dibits, the FEC's decoded blocks with their CRC verdicts and the MAC's
cell display are judged against the truth, not against a second
receiver.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

SLOTS_PER_MULTIFRAME = 72
PROBE = 64              # dibits that place a block's output in the air
PROBE_MISMATCH = 8      # at most this many of them may differ at a candidate


def dibit_errors(dib: np.ndarray, val: np.ndarray, carriers, cell_of,
                 sent: list, first_symbol: float, n_expected: int,
                 search: int = 400) -> tuple[int, int]:
    """One demod block's dibits against the air on `carriers`.

    dib/val: (slots, C) arrays of the block (val nonzero where the slot
    holds a symbol; slots in time order).  The block's valid dibits of
    carrier c must be a run of sent[cell_of[c]] (periodic) starting
    within `search` symbols of first_symbol.  The run is placed by its
    first PROBE dibits, then every dibit is compared; a block whose
    symbol count is off by more than one counts the difference as
    errors, and a block that cannot be placed counts n_expected errors.
    Returns (errors, n_expected * len(carriers))."""
    errors = 0
    base = int(np.floor(first_symbol)) - search
    offs = base + np.arange(2 * search)
    for c in carriers:
        s = sent[cell_of[c]]
        M = len(s)
        r = (dib[:, c][val[:, c] != 0] & 3).astype(np.uint8)
        if len(r) < PROBE:
            errors += n_expected
            continue
        probe = s[(offs[:, None] + np.arange(PROBE)[None]) % M]
        near = offs[(probe != r[:PROBE][None]).sum(axis=1) <= PROBE_MISMATCH]
        if not len(near):
            errors += n_expected
            continue
        full = np.arange(len(r))
        best = min(int((s[(o + full) % M] != r).sum()) for o in near)
        errors += best + max(0, abs(len(r) - n_expected) - 1)
    return errors, n_expected * len(carriers)


def slot_of(mn, fn, tn, period_slots: int, mn0: int = 1):
    """Period slot index of a receiver's (multiframe, frame, timeslot)
    stamp; the air's multiframe number restarts at mn0 each period while
    the receiver counts on until its next SYNC PDU, hence the modulo."""
    n_mf = period_slots // SLOTS_PER_MULTIFRAME
    return (((np.asarray(mn) - mn0) % n_mf) * SLOTS_PER_MULTIFRAME
            + (np.asarray(fn) - 1) * 4 + (np.asarray(tn) - 1))


# a block's place in its slot by (type, number): SB1 / NDB block 1 first,
# the broadcast block second, SB2 / NDB block 2 third
_POS = {(0, 1): 0, (3, 0): 1, (1, 2): 2, (2, 1): 0, (2, 2): 2}
_T1_BYTES = 34


class SentBlocks:
    """Every sent block as packed type-1 bits, by (cell, period slot,
    place in the slot), with its type and a mask of its type-1 bits."""

    def __init__(self, records: list):
        n_cells, n_slots = len(records), len(records[0])
        self.bits = np.zeros((n_cells, n_slots, 3, _T1_BYTES), np.uint8)
        self.mask = np.zeros((n_cells, n_slots, 3, _T1_BYTES), np.uint8)
        self.btype = np.full((n_cells, n_slots, 3), -1, np.int64)
        for i, recs in enumerate(records):
            for p, rec in enumerate(recs):
                for (bt, bn), bits in rec.items():
                    k = _POS[(bt, bn)]
                    pad = np.zeros(_T1_BYTES * 8, np.uint8)
                    pad[:len(bits)] = bits
                    self.bits[i, p, k] = np.packbits(pad)
                    pad[:len(bits)] = 1
                    self.mask[i, p, k] = np.packbits(pad)
                    self.btype[i, p, k] = bt


def block_errors(rows: dict, cell_of, sent: SentBlocks,
                 period_slots: int) -> tuple[int, int]:
    """Decoded blocks with a good CRC against the sent ones.

    rows: arrays chan, btype, bnum, mn, fn, tn (the TDMA time the
    receiver's MAC gave the block), ok (CRC verdict) and type1 (packed
    bits, MSB first).  A good-CRC block is wrong if its carrier holds no cell, if
    no block of its type and number was sent in its slot, or if its bits
    differ from the sent ones.  Returns (wrong, good-CRC blocks, the
    wrong rows' indices)."""
    ok = np.asarray(rows["ok"], bool)
    cell = np.asarray(cell_of)[rows["chan"][ok]]
    bt, bn = rows["btype"][ok], rows["bnum"][ok]
    pos = np.array([_POS.get((int(a), int(b)), -1) for a, b in zip(bt, bn)],
                   np.int64)
    slot = slot_of(rows["mn"][ok], rows["fn"][ok], rows["tn"][ok],
                   period_slots)
    known = (cell >= 0) & (pos >= 0)
    c, p, k = cell[known], slot[known], pos[known]
    diff = ((rows["type1"][ok][known] ^ sent.bits[c, p, k])
            & sent.mask[c, p, k]).any(axis=1)
    diff |= sent.btype[c, p, k] != bt[known]
    bad = np.nonzero(ok)[0][~known]
    bad = np.concatenate([bad, np.nonzero(ok)[0][known][diff]])
    return int(len(bad)), int(ok.sum()), np.sort(bad)


def explain_row(rows: dict, i: int, cell_of, sent: SentBlocks,
                period_slots: int, reach: int = 100) -> str:
    """One wrong block in words: its carrier, type, stamp and the slots
    within `reach` of its stamp whose sent block it equals."""
    chan, bt, bn = (int(rows[k][i]) for k in ("chan", "btype", "bnum"))
    stamp = tuple(int(rows[k][i]) for k in ("mn", "fn", "tn"))
    cell, pos = int(cell_of[chan]), _POS.get((bt, bn), -1)
    if cell < 0 or pos < 0:
        return f"carrier {chan} (cell {cell}) block {bt}/{bn} stamp {stamp}"
    p = int(slot_of(*stamp, period_slots))
    hits = [d for d in range(-reach, reach + 1)
            if sent.btype[cell, (p + d) % period_slots, pos] == bt
            and not ((rows["type1"][i] ^ sent.bits[cell, (p + d)
                                                   % period_slots, pos])
                     & sent.mask[cell, (p + d) % period_slots, pos]).any()]
    return (f"carrier {chan} cell {cell} block {bt}/{bn} stamp {stamp} "
            f"slot {p}: equals the sent block at slot offsets {hits[:4]}")


def display_errors(states: list, cell_of, cells: list) -> int:
    """Carriers whose end state is wrong: an occupied carrier must be
    locked, must not have lost lock in the window, and must show its own
    cell (MCC, MNC, colour code); an empty carrier must show no cell.
    states[c] = (locked, mcc, mnc, cc, lock losses in the window)."""
    bad = 0
    for c, (locked, mcc, mnc, cc, losses) in enumerate(states):
        if cell_of[c] < 0:
            bad += (mcc, mnc, cc) != (0, 0, 0)
        else:
            cell = cells[cell_of[c]]
            bad += (not locked or losses != 0
                    or (mcc, mnc, cc) != (cell.mcc, cell.mnc, cell.cc))
    return bad
