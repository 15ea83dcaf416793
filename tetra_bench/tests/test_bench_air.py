"""The benchmark's air: the frozen generator against the program's TX
fixture, the periodic synthesis, and the program's receiver on it across
the wrap."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tetra_bench.air import protocol as P
from tetra_bench.air.downlink import Cell, downlink
from tetra_bench.air.synth import build_air, cells_of
from tetra_bench.reference import frontend as RF

CELLS = dict(count=8, mcc=262, mnc0=100, cc0=1)
C, T50, WB_K = 16, 6400, 8


def small_air(occupied, seed, period_multiframes=4):
    adv = T50 * C // 2
    return build_air(C, cells_of(CELLS), occupied, period_multiframes, 25.0,
                     400.0, seed, "cpu", ext=(WB_K + 2) * adv + 128 * C)


def test_downlink_matches_the_program_fixture():
    from tetra_tpu_torch.rx.tdma import TdmaTime
    from tetra_tpu_torch.tx.cell import CellConfig, downlink_bits
    bits, recs = downlink(Cell(262, 103, 4), 300, np.random.default_rng(9))
    ref, rrecs = downlink_bits(CellConfig(mcc=262, mnc=103, cc=4), 300,
                               start=TdmaTime(mn=1, fn=1, tn=0),
                               payload_rng=np.random.default_rng(9))
    assert np.array_equal(bits, ref)
    names = {(P.T_SB1, 1): "sb1", (P.T_SB2, 2): "sb2", (P.T_BBK, 0): "aach",
             (P.T_NDB, 1): "ndb1", (P.T_NDB, 2): "ndb2"}
    for rec, rr in zip(recs, rrecs):
        assert rr.kind in ("sync", "ndb")
        assert {names[k]: v.tolist() for k, v in rec.items()} == \
            {k: v.tolist() for k, v in rr.type1.items() if k != "sdu"}


def test_every_burst_closes_its_phase():
    bits, _ = downlink(Cell(262, 100, 1), 288, np.random.default_rng(1))
    dib = (bits[0::2] << 1) | bits[1::2]
    sums = P.DIBIT_STEP[dib].reshape(288, 255).sum(axis=1) % 8
    assert set(sums.tolist()) == {7}          # 288 x 7 = 0 mod 8


def test_air_is_periodic_with_the_stated_levels():
    occupied = np.arange(C) % 2 == 0
    air = small_air(occupied, 2 ** 31 + 11)
    n, ext = air.period, len(air.re) - air.period
    assert n == C * 102_000
    assert torch.equal(air.re[n:], air.re[:ext])
    assert torch.equal(air.im[n:], air.im[:ext])
    x = torch.complex(air.re[:n].double(), air.im[:n].double())
    spec = torch.fft.fft(x).abs().square().reshape(C, -1)
    # carrier c occupies bins c*25 kHz +-12.5 kHz, wrapped
    spec = torch.roll(spec.reshape(-1), 51_000).reshape(C, -1)
    power = spec.sum(dim=1) / float(n) ** 2
    on, off = power[torch.from_numpy(occupied)], power[~torch.from_numpy(
        occupied)]
    assert torch.allclose(on, torch.full_like(on, 1 + 10 ** -2.5), rtol=0.02)
    assert torch.allclose(off, torch.full_like(off, 10 ** -2.5), rtol=0.05)
    # across the wrap the front end sees one stream: a block straddling it
    # equals the same block cut from a rotated copy of the period
    hop, t36 = C // 2, T50 * 18 // 25
    a = n - 3000 * hop
    rot = torch.roll(air.re[:n], -a), torch.roll(air.im[:n], -a)
    y1 = RF.front_end(air.re[a:], air.im[a:], C, T50, t36, torch.float64)
    y2 = RF.front_end(rot[0], rot[1], C, T50, t36, torch.float64)
    assert torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])


def _staged(rx, air, n_superblocks):
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    pos, wraps = air.start, 0
    for _ in range(n_superblocks):
        o = pos % air.period
        wr = air.re.as_strided((WB_K, wl), (adv, 1), o).contiguous()
        wi = air.im.as_strided((WB_K, wl), (adv, 1), o).contiguous()
        rx.process_wideband_staged(wr, wi)
        pos += WB_K * adv
        wraps += (pos % air.period) < o
    return wraps


def test_receiver_stays_locked_across_two_wraps():
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    torch.set_num_threads(4)
    air = small_air(np.ones(C, bool), 77)
    rx = TetraReceiver(wideband=C, t50=T50, fleet=True, wb_k=WB_K,
                       device="cpu")
    _staged(rx, air, 2)
    assert all(rx.locked(c) for c in range(C))
    losses = [rx.fleet.lock_losses(c) for c in range(C)]
    sb_air = WB_K * rx._wb["advance"]
    n = -(-(2 * air.period + air.period // 4) // sb_air)
    assert _staged(rx, air, n) >= 2
    cells = cells_of(CELLS)
    for c in range(C):
        d, cell = rx.display(c), cells[c % 8]
        assert rx.locked(c)
        assert rx.fleet.lock_losses(c) == losses[c]
        assert (d.mcc, d.mnc, d.cc) == (cell.mcc, cell.mnc, cell.cc)
        assert rx.crc_counts(c)[1] == 0


def test_no_empty_carrier_adopts_a_cell():
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    torch.set_num_threads(4)
    occupied = np.zeros(C, bool)
    occupied[[3, 12]] = True
    air = small_air(occupied, 5)
    rx = TetraReceiver(wideband=C, t50=T50, fleet=True, wb_k=WB_K,
                       device="cpu")
    _staged(rx, air, 5)
    for c in range(C):
        d = rx.display(c)
        if occupied[c]:
            assert rx.locked(c) and d.mnc == 100 + c % 8
        else:
            assert (d.mcc, d.mnc, d.cc) == (0, 0, 0)
            assert rx.crc_counts(c) == (0, 0)


@pytest.mark.cuda
def test_air_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    occupied = np.ones(C, bool)
    cpu = small_air(occupied, 3)
    adv = T50 * C // 2
    card = build_air(C, cells_of(CELLS), occupied, 4, 25.0, 400.0, 3,
                     torch.device("cuda"), ext=(WB_K + 2) * adv + 128 * C)
    x = torch.complex(cpu.re, cpu.im)
    y = torch.complex(card.re.cpu(), card.im.cpu())
    # the noise comes from each device's own generator: compare the
    # signal part through the channel powers
    px = x[:cpu.period].abs().square().mean()
    py = y[:card.period].abs().square().mean()
    assert abs(float(px / py) - 1) < 0.01
