"""The port's fleet engine against the port's per-channel path, bit for
bit, on the reference's streams (tests/test_fleet.py:77-150): the port's
TetraReceiver(C, fleet=True) and TetraReceiver(C, events=False,
device_acquire=False) fed the same blocks end in the same per-channel
state (lock state, lock losses, bit buffer, TDMA time, slot count, CRC
tallies, scrambling code, cell, display, MAC flags) and make the same
voice callbacks.  Both consume the same dibits, so no tolerance applies.

The IQ is the reference's own: built with tetra_tpu's TX (tx.cell,
tx.modulator) and tx.channel from its seeds, on the CPU.  The streams
also feed tests/test_torch_marginal.py.  Last, the wideband form on
tx.wideband.marginal_air (8 carriers at 7.5-12 dB, one dropping out and
coming back as another cell), as chip_smoke.py's slice_marginal holds it
on the card at 256 carriers."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tetra_tpu import params as P
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu.tx.channel import channel
from tetra_tpu.tx.modulator import modulate
from tetra_tpu_torch.tx.wideband import handover_cell, marginal_air
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401
from tests.torch_parity import (assert_wide_parity, run_pair,
                                wide_receivers)

START = TdmaTime(mn=1, fn=17, tn=4)
MULTICELL = [cell.CellConfig(mcc=262, mnc=1234, cc=7),
             cell.CellConfig(mcc=901, mnc=42, cc=11),
             cell.CellConfig(mcc=310, mnc=9999, cc=63)]
CELL_A = cell.CellConfig(mcc=262, mnc=1234, cc=7)
CELL_B = cell.CellConfig(mcc=901, mnc=42, cc=11)


@lru_cache(maxsize=None)
def multicell_iq() -> np.ndarray:
    """test_fleet.py:77: three cells, 22 dB, 180 Hz CFO."""
    streams = []
    for cfg in MULTICELL:
        bits, _ = cell.downlink_bits(cfg, 150, start=START.copy())
        streams.append(np.asarray(modulate(jnp.asarray(bits[None, :])))[0])
    L = min(len(s) for s in streams)
    iq = np.stack([s[:L] for s in streams])
    return np.asarray(channel(jnp.asarray(iq), jax.random.key(3),
                              snr_db=22.0, cfo_hz=180.0,
                              sample_rate=P.SAMPLE_RATE))


@lru_cache(maxsize=None)
def handover_iq() -> np.ndarray:
    """test_fleet.py:98: cell A with voice on timeslot 2 and a stolen
    slot, 0.5 s of dead air, then cell B on a later timeline; 25 dB,
    -250 Hz."""
    rng = np.random.default_rng(19)
    framegen = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
    bits_a, _ = cell.downlink_bits(CELL_A, 170, start=START.copy(),
                                   voice_slots={2: framegen},
                                   stolen_slots={(6, 2)})
    bits_b, _ = cell.downlink_bits(CELL_B, 120,
                                   start=TdmaTime(mn=9, fn=17, tn=4))
    iq_a = np.asarray(modulate(jnp.asarray(bits_a[None, :])))
    iq_b = np.asarray(modulate(jnp.asarray(bits_b[None, :])))
    gap = np.zeros((1, 18000), np.complex64)
    iq = np.concatenate([iq_a, gap, iq_b], axis=1)
    return np.asarray(channel(jnp.asarray(iq), jax.random.key(5),
                              snr_db=25.0, cfo_hz=-250.0,
                              sample_rate=P.SAMPLE_RATE))


@lru_cache(maxsize=None)
def low_snr_iq() -> np.ndarray:
    """test_fleet.py:125: one cell on 8 channels at 7.5 + 0.5 c dB, CFOs
    spread over +-400 Hz, independent noise keys."""
    bits, _ = cell.downlink_bits(CELL_A, 130, start=START.copy())
    one = np.asarray(modulate(jnp.asarray(bits[None, :])))[0]
    key = jax.random.key(11)
    cfos = np.linspace(-400.0, 400.0, 8)
    rows = []
    for c in range(8):
        key, k = jax.random.split(key)
        rows.append(np.asarray(channel(jnp.asarray(one[None]), k,
                                       snr_db=7.5 + 0.5 * c, cfo_hz=cfos[c],
                                       sample_rate=P.SAMPLE_RATE))[0])
    return np.stack(rows)


def test_fleet_parity_basic_multicell():
    rx_f, _, _ = run_pair(multicell_iq())
    for c, cfg in enumerate(MULTICELL):
        assert rx_f.locked(c), c
        d = rx_f.display(c)
        assert (d.mcc, d.mnc, d.cc) == (cfg.mcc, cfg.mnc, cfg.cc), c
        assert rx_f.crc_counts(c)[0] > 100, c


def test_fleet_parity_dropout_handover_voice_stealing():
    """Voice traffic, slot stealing, and a dropout re-acquired on a
    different cell (a new scrambling code mid-stream)."""
    rx_f, _, voice = run_pair(handover_iq(), voice=True)
    assert rx_f.fleet.lock_losses(0) >= 1 and rx_f.locked(0)
    d = rx_f.display(0)
    assert (d.mcc, d.mnc, d.cc) == (CELL_B.mcc, CELL_B.mnc, CELL_B.cc)
    assert int(rx_f.fleet.scramb[0]) == P.scramb_get_init(
        CELL_B.mcc, CELL_B.mnc, CELL_B.cc)
    assert len(voice) > 10


def test_fleet_parity_low_snr_fuzz():
    """8 channels at 7.5-11 dB: CRC failures, training-sequence misses and
    unlock/relock churn, yet the two state machines track each other."""
    rx_f, rx_p, _ = run_pair(low_snr_iq())
    assert any(rx_f.locked(c) for c in range(8))
    assert sum(rx_p.mac[c].crc_fails for c in range(8)) > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_fleet_parity_wideband_marginal(seed):
    """tx.wideband.marginal_air at 8 carriers (7.5-12 dB, carrier 7 drops
    out at 0.8 s for 0.5 s and comes back as another cell) through the
    wideband fleet receiver (wb_k = 4), a one-cycle fleet receiver and the
    per-channel one (tests/torch_parity.assert_wide_parity): the
    one-cycle fleet equals the per-channel receiver bit for bit, the
    superblock fleet equals them but, where its CRC tallies differ, in
    what decoded blocks set, and no carrier adopts a cell (a CRC-checked
    SYNC PDU) other than its own."""
    wide, plan = marginal_air(8, 2.2, dropout_at=0.8, seed=seed,
                              device="cpu")
    rx_k, rx_1, rx_p, _ = wide_receivers(wide, 8, 1600, 4)
    assert_wide_parity(rx_k, rx_1, rx_p)
    for c in range(8):
        ch = rx_k.fleet.chan(c)
        own = [(262, 100 + plan["cell"][c], 1 + plan["cell"][c]), (0, 0, 0)]
        if plan["handover"][c]:
            new = handover_cell(plan["new_cell"][c])
            own.append((new.mcc, new.mnc, new.cc))
        assert (ch.cell_mcc, ch.cell_mnc, ch.cell_cc) in own, c


def test_superblock_adoption_redecodes_the_whole_call():
    """Where the superblock fleet and the per-cycle paths part: a cell's
    first SYNC burst locks the receiver but its SYNC PDU fails its CRC, so
    the bursts after it decode under the initial scrambling code and fail
    until the next SYNC PDU (72 slots on) is adopted.  A fleet engine fed
    16 cycles a call re-decodes those bursts under the adopted code and
    counts them passed; a one-cycle engine and BurstSync + LowerMac fed
    one cycle a call counted them failed in earlier calls, and agree with
    each other.  Built at the bit level: the cell's bits with the first
    SYNC PDU's type-5 bits garbled."""
    from tetra_tpu_torch import params as TP
    from tetra_tpu_torch.rx.burst_sync import BurstSync
    from tetra_tpu_torch.rx.fleet import FleetEngine
    from tetra_tpu_torch.rx.lower_mac import LowerMac
    from tetra_tpu_torch.rx.tdma import PhyState
    from tetra_tpu_torch.rx.tdma import TdmaTime as TTdmaTime
    from tetra_tpu_torch.tx.cell import CellConfig, downlink_bits
    bits, records = downlink_bits(CellConfig(mcc=262, mnc=77, cc=5), 160,
                                  start=TTdmaTime(mn=1, fn=17, tn=4))
    s0 = next(i for i, r in enumerate(records) if r.kind == "sync")
    bits = bits.copy()
    blk = s0 * 510 + TP.SB_BLK1_OFFSET
    bits[blk:blk + TP.SB_BLK1_BITS:2] ^= 1
    T, K = 2400, 16
    dib = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8) | 0x80
    cycles = np.stack([dib[j * T:(j + 1) * T]
                       for j in range(len(dib) // T // K * K)])
    one, whole = FleetEngine(1, "cpu"), FleetEngine(1, "cpu")
    phy = PhyState()
    sync, mac = BurstSync(phy=phy), LowerMac(phy=phy, device="cpu")
    mac.upper.events_enabled = False
    for j, cyc in enumerate(cycles):
        one.process_packed(cyc[None])
        mac.process_bursts(sync.feed(bits[j * 2 * T:(j + 1) * 2 * T]))
    for j in range(0, len(cycles), K):
        whole.process_packed_cycles(cycles[j:j + K, None])
    ok1, fail1 = one.crc_counts(0)
    okk, failk = whole.crc_counts(0)
    assert (ok1, fail1) == (mac.crc_oks, mac.crc_fails)
    assert okk > ok1 and failk < fail1 and okk + failk == ok1 + fail1, (
        (okk, failk), (ok1, fail1))
    assert bytes(whole.chan(0).mac) == bytes(one.chan(0).mac)
    assert whole.display(0).as_dict() == one.display(0).as_dict()
