"""The fleet engine's per-channel state against the per-channel path's.

A fleet receiver (TetraReceiver(..., fleet=True): C++ burst sync, packed
FEC and MAC dispatch in rx/fleet.FleetEngine) and a per-channel receiver
(TetraReceiver(..., events=False, device_acquire=False): BurstSync,
LowerMac and the native MAC core per channel) fed the same dibits must
end in the same state bit for bit: the reference's tests/test_fleet.py
holds its two paths to this, field by field.
"""

from __future__ import annotations


def channel_mismatches(rx_fleet, rx_chan, c: int) -> list[str]:
    """The names of channel c's observables where the fleet receiver's
    engine state differs from the per-channel receiver's BurstSync and
    LowerMac; empty when they agree: lock state, lock losses, the bit
    buffer (start, length, bytes), TDMA time, slot count, CRC tallies,
    scrambling code, cell, display and the MAC flag fields."""
    sync, mac = rx_chan.sync[c], rx_chan.mac[c]
    ch = rx_fleet.fleet.chan(c)
    t, tp = ch.time, sync.phy.time
    up, m = mac.upper, ch.mac
    checks = {
        "state": (ch.state, sync.state),
        "lock_losses": (ch.lock_losses, sync.lock_losses),
        "start_bitnum": (ch.start_bitnum, sync.bitbuf_start_bitnum),
        "bitbuf": (bytes(ch.buf[:ch.buf_len]), sync.bitbuf.tobytes()),
        "time": ((t.hn, t.mn, t.fn, t.tn, t.sn),
                 (tp.hn, tp.mn, tp.fn, tp.tn, tp.sn)),
        "slot_count": (ch.slot_count, sync.phy.slot_count),
        "crc_counts": (rx_fleet.fleet.crc_counts(c),
                       (mac.crc_oks, mac.crc_fails)),
        "scramb": (int(rx_fleet.fleet.scramb[c]), mac.cell.scramb_init),
        "cell": ((ch.cell_mcc, ch.cell_mnc, ch.cell_cc),
                 (mac.cell.mcc, mac.cell.mnc, mac.cell.colour_code)),
        "display": (rx_fleet.display(c).as_dict(),
                    rx_chan.display(c).as_dict()),
        "mac_flags": ((m.is_traffic, bool(m.blk1_stolen),
                       bool(m.blk2_stolen), m.ssi, m.addr_type,
                       m.usage_marker),
                      (up.is_traffic, up.blk1_stolen, up.blk2_stolen,
                       up.ssi, up.addr_type, up.usage_marker)),
    }
    return [k for k, (a, b) in checks.items() if a != b]
