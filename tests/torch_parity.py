"""Helpers that hold the port's fleet receiver against its per-channel
receiver on the same air (no jax, no tetra_tpu: tests/test_torch_import.py
runs them with both blocked).

The fleet receiver (TetraReceiver(..., fleet=True), the native fleet
engine) and the per-channel one (events=False, device_acquire=False:
BurstSync, LowerMac and the native MAC core per channel) consume the same
dibits, so every piece of per-channel state must be equal bit for bit
(tetra_tpu_torch/rx/parity.py, the port of the reference's
tests/test_fleet.py:27-52 `_assert_parity`)."""

from __future__ import annotations

import numpy as np

from tetra_tpu_torch.rx.parity import channel_mismatches
from tetra_tpu_torch.rx.receiver import TetraReceiver


def assert_parity(rx_f, rx_p) -> None:
    bad = {c: channel_mismatches(rx_f, rx_p, c) for c in range(rx_p.channels)}
    bad = {c: v for c, v in bad.items() if v}
    assert not bad, bad


def run_pair(iq: np.ndarray, block: int = 4096, voice: bool = False):
    """Narrowband (C, T) air at 36 kHz through both receivers in `block`
    columns a call (test_fleet.py:55 `_run_pair`).  Asserts parity and
    equal voice callbacks; returns (fleet, per-channel, voice frames)."""
    C = iq.shape[0]
    voice_f, voice_p = [], []

    def sink(out):
        return (lambda t, b: out.append((str(t), b.tobytes()))) if voice \
            else None

    rx_f = TetraReceiver(C, fleet=True, voice_cb=sink(voice_f), device="cpu")
    rx_p = TetraReceiver(C, events=False, voice_cb=sink(voice_p),
                         device_acquire=False, device="cpu")
    for i in range(iq.shape[1] // block):
        blk = iq[:, i * block:(i + 1) * block]
        rx_f.process(blk)
        rx_p.process(blk)
    assert_parity(rx_f, rx_p)
    assert voice_f == voice_p
    return rx_f, rx_p, voice_f


def whole_superblocks(wide: np.ndarray, advance: int, wide_len: int,
                      wb_k: int) -> np.ndarray:
    """The head of wide that a fleet receiver consumes as whole
    superblocks of wb_k windows, and a per-channel receiver as exactly
    that many cycles."""
    n = (len(wide) - (wide_len - advance)) // (wb_k * advance)
    return wide[:(wide_len - advance) + n * wb_k * advance]


def wide_receivers(wide: np.ndarray, n_ch: int, t50: int, wb_k: int,
                   device="cpu"):
    """Wideband air through TetraReceiver(wideband=n_ch, fleet=True,
    wb_k=wb_k) fed whole superblocks, and, fed the same cycles one a call,
    a one-cycle fleet receiver (wb_k=1) and the per-channel
    TetraReceiver(wideband=n_ch, events=False, device_acquire=False).
    Returns (superblock fleet, one-cycle fleet, per-channel, the air they
    consumed); assert_wide_parity checks them."""
    rx_k = TetraReceiver(wideband=n_ch, t50=t50, fleet=True, wb_k=wb_k,
                         device=device)
    rx_1 = TetraReceiver(wideband=n_ch, t50=t50, fleet=True, device=device)
    rx_p = TetraReceiver(wideband=n_ch, t50=t50, events=False,
                         device_acquire=False, device=device)
    adv, wl = rx_k._wb["advance"], rx_k._wb["wide_len"]
    wide = whole_superblocks(wide, adv, wl, wb_k)
    rx_k.process_wideband(wide)
    rx_k.flush_wideband()
    for i in range(0, len(wide), adv):
        rx_1.process_wideband(wide[i:i + adv])
        rx_p.process_wideband(wide[i:i + adv])
    return rx_k, rx_1, rx_p, wide


DECODE_FIELDS = {"crc_counts", "mac_flags", "display"}


def assert_wide_parity(rx_k, rx_1, rx_p) -> dict:
    """The one-cycle fleet equals the per-channel receiver bit for bit.
    The superblock fleet equals them but, on channels whose CRC tallies
    differ, in what decoded blocks set (DECODE_FIELDS): its scrambling
    adoption re-decodes the rows of the whole call (wb_k cycles) under a
    channel's new code, rows before the adopting SYNC PDU included, where
    the other two re-decode one cycle's (FleetEngine._decode_dispatch,
    LowerMac.decode_bursts_multi), and a row that passes in one and not
    the other is dispatched in one only.  Returns {channel: (superblock,
    one-cycle) CRC tallies} where they differ."""
    assert_parity(rx_1, rx_p)
    scope = {}
    for c in range(rx_p.channels):
        m = channel_mismatches(rx_k, rx_p, c)
        assert not m or ("crc_counts" in m and set(m) <= DECODE_FIELDS), (
            c, m)
        if m:
            scope[c] = (rx_k.crc_counts(c), rx_1.crc_counts(c))
    return scope
