"""The per-layer metrics that read the program's own spans and counters
(program_spans.py, metrics/ of layer fetch, engine, FEC and ingest):
the window is the run's superblocks, after the warm-up's and before the
six profiled ones; each metric is None where the program keeps no
records or too few; on the card every such metric reads in its cells."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from conftest import REPO

from tetra_bench import harness, program_spans

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)


def _reads_spans(name: str) -> bool:
    with open(os.path.join(REPO, "tetra_bench", "metrics",
                           name + ".py")) as f:
        return "program_spans" in f.read()


PROFILED = harness.PROFILE_DEVICE_SB + harness.PROFILE_SPAN_SB
WARM, WINDOW = 5, 7


def _records(n_warm: int, n_window: int, n_after: int):
    """Records whose window rows read EXPECTED's numbers (fetch 1, 2, ...
    ms) and whose other rows read 10**12 in every field."""
    from tetra_tpu_torch import spans
    n = n_warm + n_window + n_after
    rec = np.zeros(n, spans.RECORD)
    rec["seq"] = np.arange(n)
    big = np.full(n, 10 ** 12)
    w = slice(n_warm, n_warm + n_window)
    k = np.arange(1, n_window + 1)
    for name in spans.SPANS + spans.COUNTERS:
        rec[name] = big
    rec["fetch"][w] = k * 10 ** 6
    rec["engine"][w] = 100 * 10 ** 6
    rec["engine.feed"][w] = 30 * 10 ** 6
    rec["fec"][w] = 50 * 10 ** 6
    rec["fec.wait"][w] = 4 * 10 ** 6
    rec["engine.dispatch"][w] = 5 * 10 ** 6
    rec["hunt.bits"][w] = 33 * 10 ** 6
    rec["fec.rows"][w] = 1000
    rec["ingest.bytes_fed"][w] = 8 * 10 ** 6
    rec["ingest.bytes_copied"][w] = 52 * 10 ** 6
    for name in ("ingest.buffer", "ingest.frame", "ingest.upload"):
        rec[name][w] = 7 * 10 ** 6
    return rec


EXPECTED = {"fetch_wait_ms": (WINDOW + 1) / 2, "engine_feed_ms": 30.0,
            "engine_dispatch_ms": 5.0, "engine_self_ms": 15.0,
            "hunt_mbit": 33.0, "fec_enqueue_ms": 46.0, "fec_wait_ms": 4.0,
            "fec_rows": 1000.0, "ingest_buffer_ms": 7.0,
            "ingest_frame_ms": 7.0, "ingest_upload_ms": 7.0,
            "ingest_copy_ratio": 6.5}


def _read(name: str, run):
    return harness.load_reader(REPO, name)(run)


def test_every_span_metric_has_a_case():
    names = [m["name"] for m in MANIFEST["per_layer"]]
    assert sorted(n for n in names if _reads_spans(n)) == sorted(EXPECTED)


def test_window_drops_warm_up_and_profiled_superblocks(monkeypatch):
    from tetra_tpu_torch import spans
    monkeypatch.setattr(spans, "records",
                        lambda: _records(WARM, WINDOW, PROFILED))
    run = harness.Run(carriers=16, superblocks=WINDOW)
    rec = program_spans.window(run)
    assert list(rec["seq"]) == list(range(WARM, WARM + WINDOW))
    for name, want in EXPECTED.items():
        assert _read(name, run) == pytest.approx(want), name


def test_readers_return_none_without_records(monkeypatch):
    from tetra_tpu_torch import spans
    run = harness.Run(carriers=16, superblocks=WINDOW)
    # fewer records than the window and the profiled stretches
    monkeypatch.setattr(spans, "records",
                        lambda: _records(0, WINDOW, PROFILED - 1))
    assert all(_read(n, run) is None for n in EXPECTED)
    # a run that decoded no superblock
    monkeypatch.setattr(spans, "records",
                        lambda: _records(WARM, WINDOW, PROFILED))
    empty = harness.Run(carriers=16)
    assert all(_read(n, empty) is None for n in EXPECTED)
    # a program without the tracer (the import fails)
    import tetra_tpu_torch
    monkeypatch.delattr(tetra_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "tetra_tpu_torch.spans", None)
    assert all(_read(n, run) is None for n in EXPECTED)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"]
                                      for w in MANIFEST["workloads"]])
def test_every_span_metric_reads_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    result, checks = harness.run_cell(REPO, workload, 2 ** 31 + 41, 5.0,
                                      True, time.perf_counter())
    assert result["correct"], checks
    want = {m["name"] for m in harness.metrics_of(MANIFEST, workload,
                                                  "per_layer")
            if m["name"] in EXPECTED}
    assert want and want <= set(result["metrics"]), (want, result)
