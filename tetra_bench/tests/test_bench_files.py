"""A later change adds a configuration, a traffic mix and a metric by
adding files and manifest entries: the harness finds them by name, and no
file that was there changes."""

from __future__ import annotations

import hashlib
import json
import os

from conftest import run_small


def _hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "tetra_bench")):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_and_a_metric_added_by_files(bench_copy):
    bench = os.path.join(bench_copy, "tetra_bench")
    before = _hashes(bench_copy)
    with open(os.path.join(bench, "configs", "band256.json")) as f:
        cfg = json.load(f)
    cfg["receiver"]["wideband"] = 32
    with open(os.path.join(bench, "configs", "extra32.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "half.json"), "w") as f:
        json.dump({"feed": "staged", "occupancy": 0.5,
                   "period_multiframes": 4, "warmup_s": 1.5}, f)
    with open(os.path.join(bench, "metrics", "superblocks_done.py"),
              "w") as f:
        f.write('"""Superblocks the window decoded."""\n\n\n'
                'def read(run):\n    return float(run.superblocks)\n')
    path = os.path.join(bench_copy, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["workloads"].append(
        {"name": "extra32.half", "config": "extra32", "traffic": "half",
         "chips": 1, "why": "added by files"})
    manifest["end_to_end"].append(
        {"name": "superblocks_done", "unit": "superblocks",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": ["extra32.half"]})
    with open(path, "w") as f:
        json.dump(manifest, f)

    result, checks = run_small(bench_copy, "extra32.half", 2 ** 32 + 3, 2.0)
    assert result["correct"], checks
    assert result["metrics"]["superblocks_done"]["value"] >= 1
    assert set(result["metrics"]) == {"rt_carriers", "setup_s",
                                      "superblocks_done"}
    assert result["attempted"] > 0 and result["failed"] == 0
    after = _hashes(bench_copy)
    assert {k: v for k, v in after.items() if k in before} == before
