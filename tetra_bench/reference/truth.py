"""The receiver's answers against what the air carried.

The air is the benchmark's own (tetra_bench.air): every carrier's sent
dibits and every block's type-1 bits are known exactly, so the demod's
dibits, the FEC's decoded blocks with their CRC verdicts and the MAC's
cell display are judged against the truth, not against a second
receiver.  Nothing here imports the program.

Blocks expected, slot by slot: the blocks the air's record of a slot
holds, which are the blocks the fleet engine counts when it decodes them
with a good CRC: 3 on a signalling slot (SYNC, AACH, SYSINFO; or NDB 1,
AACH, NDB 2), 1 on a voice slot (the AACH; the SCH/F carries speech,
whose CRC fails, a failure the engine does not count), 2 on a
first-half steal (STCH, AACH; the speech half's CRC fails) and 3 on a
steal of both halves.

Chance CRC passes on speech: a CRC-16 passes on speech bits 2^-16 of the
time, the SCH/F of a voice slot or the NDB-2 decode of a first steal's
speech half.  Such a good-CRC block is no answer of the receiver's: it
is neither wrong nor counted among the good blocks compared, where the
air sent speech in that place of that slot, by the block's own stamp,
and its bits equal no block of its type that the cell sent in that place
in any slot of the period; on a slot the air marked as signalling every
good-CRC block is compared, and so is a signalling block stamped onto a
speech slot.  How many a window holds: the engine decodes hard bits, the
air is periodic and its bits all but free of errors at the cells' SNR,
so each distinct speech block (a cell's speech slot in the period)
passes in every period or in none.  A seed's air holds about 2^-16 x its
distinct speech blocks: 8 cells with a call on one timeslot over 8
multiframes have 992 (896 SCH/F, 96 speech halves), so about 1 seed in
66 has one; where it has, the pass comes on every carrier of that cell
in every period the window decodes, some hundreds of good blocks at 256
carriers, and none at all on most seeds.  The counters cannot tell such
a pass from a block, so missed blocks are counted carrier by carrier: a
carrier's surplus of good blocks offsets no other carrier's misses, and
on its own carrier hides at most the passes' count.
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


# a block's place in its slot by (type, number): SB1 / NDB block 1 / the
# full-slot SCH/F first, the broadcast block second, SB2 / NDB block 2
# third
T_NDB, T_SCH_F = 2, 5
_POS = {(0, 1): 0, (3, 0): 1, (1, 2): 2, (2, 1): 0, (2, 2): 2, (5, 0): 0}
_T1_BYTES = 34


class SentBlocks:
    """Every sent block as packed type-1 bits, by (cell, period slot,
    place in the slot), with its type and a mask of its type-1 bits; the
    blocks expected of each slot; and where the air sent speech in a
    block's place, the type of the block whose CRC can pass there by
    chance."""

    def __init__(self, records: list):
        n_cells, n_slots = len(records), len(records[0])
        self.bits = np.zeros((n_cells, n_slots, 3, _T1_BYTES), np.uint8)
        self.mask = np.zeros((n_cells, n_slots, 3, _T1_BYTES), np.uint8)
        self.btype = np.full((n_cells, n_slots, 3), -1, np.int64)
        self.speech = np.full((n_cells, n_slots, 3), -1, np.int64)
        self.expected = np.zeros((n_cells, n_slots), np.int64)
        # every block each cell sent, by (cell, place, type): packed bits
        self.sent_set: dict = {}
        for i, recs in enumerate(records):
            for p, rec in enumerate(recs):
                if "frames" in rec:
                    self.speech[i, p, _POS[(T_SCH_F, 0)]] = T_SCH_F
                if "half_frame" in rec:
                    self.speech[i, p, _POS[(T_NDB, 2)]] = T_NDB
                for key, bits in rec.items():
                    if not isinstance(key, tuple):
                        continue
                    bt, bn = key
                    self.expected[i, p] += 1
                    k = _POS[(bt, bn)]
                    pad = np.zeros(_T1_BYTES * 8, np.uint8)
                    pad[:len(bits)] = bits
                    self.bits[i, p, k] = np.packbits(pad)
                    pad[:len(bits)] = 1
                    self.mask[i, p, k] = np.packbits(pad)
                    self.btype[i, p, k] = bt
                    self.sent_set.setdefault((i, k, bt), set()).add(
                        self.bits[i, p, k].tobytes())

    def sent_anywhere(self, cell: int, place: int, btype: int,
                      type1: np.ndarray) -> bool:
        """Whether packed type-1 bits equal a block of this type that the
        cell sent in this place of any slot of the period."""
        sent = self.sent_set.get((cell, place, btype))
        if not sent:
            return False
        mask = self.mask[cell][self.btype[cell, :, place] == btype][0, place]
        return (np.asarray(type1, np.uint8) & mask).tobytes() in sent


def expected_blocks(sent: SentBlocks, cell: int, first_slot: int,
                    n: int) -> int:
    """Blocks the air sent, and the engine counts, in the n slots of
    `cell` from period slot first_slot on."""
    if cell < 0 or n <= 0:
        return 0
    row = sent.expected[cell]
    return int(row[(first_slot + np.arange(n)) % len(row)].sum())


def block_errors(rows: dict, cell_of, sent: SentBlocks,
                 period_slots: int) -> tuple[int, int, np.ndarray, int]:
    """Decoded blocks with a good CRC against the sent ones.

    rows: arrays chan, btype, bnum, mn, fn, tn (the TDMA time the
    receiver's MAC gave the block), ok (CRC verdict) and type1 (packed
    bits, MSB first).  A good-CRC block is wrong if its carrier holds no
    cell, if no block of its type and number was sent in its slot, or if
    its bits differ from the sent ones; but a chance pass on speech (the
    module's note) is neither wrong nor compared.  Returns (wrong,
    good-CRC blocks compared, the wrong rows' indices, chance passes)."""
    ok = np.asarray(rows["ok"], bool)
    cell = np.asarray(cell_of)[rows["chan"][ok]]
    bt, bn = rows["btype"][ok], rows["bnum"][ok]
    pos = np.array([_POS.get((int(a), int(b)), -1) for a, b in zip(bt, bn)],
                   np.int64)
    slot = slot_of(rows["mn"][ok], rows["fn"][ok], rows["tn"][ok],
                   period_slots)
    known = (cell >= 0) & (pos >= 0)
    c, p, k = cell[known], slot[known], pos[known]
    chance = sent.speech[c, p, k] == bt[known]
    t1 = rows["type1"][ok][known]
    for j in np.nonzero(chance)[0]:
        chance[j] = not sent.sent_anywhere(c[j], k[j], bt[known][j], t1[j])
    diff = ((t1 ^ sent.bits[c, p, k])
            & sent.mask[c, p, k]).any(axis=1)
    diff |= sent.btype[c, p, k] != bt[known]
    diff &= ~chance
    bad = np.nonzero(ok)[0][~known]
    bad = np.concatenate([bad, np.nonzero(ok)[0][known][diff]])
    n_chance = int(chance.sum())
    return (int(len(bad)), int(ok.sum()) - n_chance, np.sort(bad),
            n_chance)


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
