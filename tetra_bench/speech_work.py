"""The least work of the voice monitor's speech decode, counted from the
full traffic slots and surviving halves it decoded: the yardstick of
speech_roofline.

Per row of the decode, the algorithm's operations, not what the batched
trellis happens to execute: each step of the 16-state rate-1/3 trellis
takes its 8 distinct branch metrics (2 additions each of three signed
soft bits) and 16 add-compare-selects (2 additions and 1 comparison
each), and each decoded bit a traceback step (1 operation); a full slot
decodes 112 (class 1) + 72 (class 2) steps and checks a CRC-8 over 60
bits (8 operations a bit), a half 56 + 38 steps and a CRC-4 over 30 (4
a bit).  Bytes: the row's packed type-5 bits read once (54), its
descrambling sequence read once (432, one byte a bit), and its frames
and flags written once (276).
"""

from __future__ import annotations

from tetra_bench import work

STEP_OPS = 8 * 2 + 16 * 3 + 1
SLOT_OPS = (112 + 72) * STEP_OPS + 60 * 8
HALF_OPS = (56 + 38) * STEP_OPS + 30 * 4
ROW_BYTES = 54 + 432 + 276


def speech_ms(slots: float, halves: float) -> float:
    """The least ms of decoding `slots` full slots and `halves` halves."""
    b = work.bound((slots + halves) * ROW_BYTES,
                   slots * SLOT_OPS + halves * HALF_OPS)
    return b["bound_ms"]
