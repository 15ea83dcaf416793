"""The frozen work counts give the program's chip check's bytes and
operations (chip_smoke.py k1_work, k2_work lean, k3_work), held here as
the numbers it printed at 256 and 1024 carriers."""

from __future__ import annotations

import pytest

from tetra_bench import work

T36, T50 = 4608, 6400
# chip_smoke.py's k1_work(4608, C, 32), k2_work(4608, C, 2432,
# emit_syms=False), k3_work(6495, C, 96, 4608): (bytes, ops)
CHIP_SMOKE = {
    256: {"k1": (19_144_084, 963_772_416), "k2": (16_939_392, 168_722_432),
          "k3": (16_233_224, 496_631_808)},
    1024: {"k1": (76_572_052, 3_855_089_664),
           "k2": (67_756_416, 674_889_728),
           "k3": (64_927_496, 2_052_063_232)},
}


@pytest.mark.parametrize("carriers", [256, 1024])
def test_work_counts_match_the_chip_check(carriers):
    got = {"k1": work.k1_work(T36, carriers),
           "k2": work.k2_work(T36, carriers, work.symbol_slots(T36)),
           "k3": work.k3_work(T50 + 95, carriers, T36)}
    for k, (n_bytes, ops) in CHIP_SMOKE[carriers].items():
        assert (got[k]["bytes"], got[k]["ops"]) == (n_bytes, ops), k
    assert work.symbol_slots(T36) == 2432
    assert work.frontend_ms(carriers, T50, T36) == got["k3"]["bound_ms"]
    assert work.demod_ms(carriers, T36) == pytest.approx(
        got["k1"]["bound_ms"] + got["k2"]["bound_ms"])
