"""The correctness check fails a run whose timed path is broken
underneath: a superblock step that returns its state unchanged, half of
the carriers left out of the batch, and a decoded block altered where
the FEC produces it.  (A cell on one chip has no exchange between chips
to leave out.)  A sound run of the same cell passes."""

from __future__ import annotations

import pytest

from conftest import SMALL_CARRIERS, run_small

SEED = 2 ** 31 + 101


def test_sound_run_is_correct(bench_copy):
    result, checks = run_small(bench_copy, "small.full", SEED)
    assert result["correct"], checks
    assert {n for n, _, _ in checks} == {
        "frontend_err", "dibit_errors", "wrong_blocks", "missed_blocks",
        "display_errors"}


def _step_keeps_state(monkeypatch):
    from tetra_tpu_torch.rx import receiver
    step = receiver._wideband_step_scan

    def stale(dstate, wrk, wik, hr, hi, *args):
        _, out, _, _ = step(dstate, wrk, wik, hr, hi, *args)
        return dstate, out, hr, hi
    monkeypatch.setattr(receiver, "_wideband_step_scan", stale)


def _half_the_carriers(monkeypatch):
    from tetra_tpu_torch.rx import receiver
    step = receiver._wideband_step_scan

    def half(*args):
        dstate, out, hr, hi = step(*args)
        out = out.clone()
        out[:-2, SMALL_CARRIERS // 2:] = 0     # no symbols for the rest
        return dstate, out, hr, hi
    monkeypatch.setattr(receiver, "_wideband_step_scan", half)


def _block_altered(monkeypatch):
    from tetra_tpu_torch.rx import fec
    decode = fec.decode_rows_typed_packed

    def altered(*args, **kw):
        t1, ok = decode(*args, **kw)
        good = ok.nonzero()[0]
        if len(good):
            t1[good[0], 0] ^= 0x80
        return t1, ok
    monkeypatch.setattr(fec, "decode_rows_typed_packed", altered)


@pytest.mark.parametrize("plant", [_step_keeps_state, _half_the_carriers,
                                   _block_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(bench_copy, monkeypatch, plant):
    plant(monkeypatch)
    result, checks = run_small(bench_copy, "small.full", SEED)
    assert not result["correct"], checks
