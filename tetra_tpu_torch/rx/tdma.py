"""TDMA time arithmetic (EN 300 392-2 clause 7.3), host side.

Mirrors tetra_tdma.c:27-99 including its normalization quirks (mn wraps with
modulo 60 keeping 0; tn normalizes only when > 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TdmaTime:
    hn: int = 0   # hyperframe
    mn: int = 1   # multiframe 1..60
    fn: int = 1   # frame 1..18
    tn: int = 1   # timeslot 1..4
    sn: int = 1   # symbol 1..255

    def _norm_mn(self):
        if self.mn > 60:
            self.mn = self.mn % 60

    def _norm_fn(self):
        if self.fn > 18:
            self.mn += self.fn // 18
            self.fn = self.fn % 18
        self._norm_mn()

    def _norm_tn(self):
        if self.tn > 4:
            self.fn += self.tn // 4
            self.tn = self.tn % 4
        self._norm_fn()

    def _norm_sn(self):
        if self.sn > 255:
            self.tn += self.sn // 255
            self.sn = (self.sn % 255) + 1
        self._norm_tn()

    def add_sym(self, n: int):
        self.sn += n
        self._norm_sn()

    def add_tn(self, n: int):
        self.tn += n
        self._norm_tn()

    def add_tn_bulk(self, n: int):
        """Advance n timeslots exactly as n repeated add_tn(1) steps (the
        reference's serial per-slot stepping).  add_tn(n) inherits
        tetra_tdma.c's normalization quirks, which are NOT additive across
        batch sizes (tn can even land on 0 for n > 1); batch-lag
        corrections and restamps -- which exist only because we batch --
        use this batching-invariant form (add_tn_serial is the C++ twin)."""
        t = self.tn - 1 + n
        self.tn = t % 4 + 1
        f = self.fn - 1 + t // 4
        self.fn = f % 18 + 1
        self.mn = (self.mn - 1 + f // 18) % 60 + 1

    def add_fn(self, n: int):
        self.fn += n
        self._norm_fn()

    def time2fn(self) -> int:
        return ((self.hn * 60 + self.mn) * 18) + self.fn

    def copy(self) -> "TdmaTime":
        return TdmaTime(self.hn, self.mn, self.fn, self.tn, self.sn)

    def __str__(self):
        return f"{self.mn:02d}/{self.fn:02d}/{self.tn}/{self.sn:03d}"


@dataclass
class PhyState:
    """Shared PHY-layer time (mirror of the reference's global
    `t_phy_state`, tetra_burst_sync.c:34): burst sync advances it per slot,
    and a decoded SYNC PDU overwrites it (tetra_lower_mac.c:277-279).

    slot_count is a monotonic received-slot counter used to correct the
    stamp lag batch processing introduces: bursts are time-stamped when the
    synchronizer emits them, but a SYNC PDU resync happens later in the MAC;
    the resync must advance by the number of slots stamped in between
    (the slot-serial reference never has such in-flight slots)."""
    time: TdmaTime = field(default_factory=TdmaTime)
    slot_count: int = 0


def is_bsch(t: TdmaTime) -> bool:
    """BSCH slot rule (tetra_lower_mac.c:118-123)."""
    return t.fn == 18 and t.tn == 4 - ((t.mn + 1) % 4)


def is_bnch(t: TdmaTime) -> bool:
    """BNCH slot rule (tetra_lower_mac.c:125-130)."""
    return t.fn == 18 and t.tn == 4 - ((t.mn + 3) % 4)
