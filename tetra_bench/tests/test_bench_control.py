"""The control: the reference in the program's place one precision below
the configuration's (bfloat16 for float32), planted under a run as the
faults are, makes the run's own check come out as not correct, by the
front-end number that the program's own run meets; at a size a CPU test
holds, and on the card at each cell's own size."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from conftest import REPO, run_small

with open(os.path.join(REPO, "tetra_bench", "limits.json")) as f:
    LIMIT = json.load(f)["frontend_err"]
with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def _frontend_err(checks) -> float:
    return dict((n, v) for n, v, _ in checks)["frontend_err"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_control_is_not_correct_where_the_program_is(bench_copy,
                                                     monkeypatch, seed):
    result, checks = run_small(bench_copy, "small.full", seed, 2.0)
    assert result["correct"], checks
    assert _frontend_err(checks) < LIMIT / 3

    def plant(harness):
        from tetra_bench import control
        control.plant(harness, monkeypatch.setattr)
    result, checks = run_small(bench_copy, "small.full", seed, 2.0, plant)
    assert not result["correct"], checks
    assert _frontend_err(checks) > 3 * LIMIT, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(monkeypatch, workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from tetra_bench import control, harness
    control.plant(harness, monkeypatch.setattr)
    result, checks = harness.run_cell(REPO, workload, 2 ** 31 + 29, 3.0,
                                      False, time.perf_counter())
    assert not result["correct"], checks
    assert _frontend_err(checks) > 3 * LIMIT, checks
