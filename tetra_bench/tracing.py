"""Reduction of torch.profiler traces to the per-layer device numbers.

Two profiled stretches of steady superblocks follow the measured window
of a traced run:

- a device stretch (CUDA activity only, so the host runs at its usual
  pace): the card's busy seconds, the union of every kernel, copy and
  memset interval, against the stretch's wall on the host clock; and
  the device operations that took the most time;
- a span stretch (CPU and CUDA): every kernel is given to each harness
  range (probes' "bench.<layer>" record_function ranges) open on the
  host when its launch was issued, so a layer's device time counts
  whatever kernels it launches under whatever names; by the same rule
  to each of the program's own ranges ("tetra.<span>", opened by
  tetra_tpu_torch.spans while a profiler records); and the card's idle
  gaps are given to the innermost harness range open at their midpoint.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", [])
                    if e.get("ph") == "X"]
    finally:
        os.remove(path)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(run, cpu: bool) -> tuple[list, float]:
    """Run `run()` under the profiler; returns the trace's complete events
    and the host-clock seconds between the card going idle before the
    work and after it."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _events(prof), wall


def device_summary(events: list, wall_s: float, top: int = 10) -> dict:
    """Busy seconds (union of device intervals), the window's wall, the
    `top` device operations by total seconds (device_ops), and every
    device operation's total seconds by name (device_op_s)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = sum(b - a for a, b in _union(
        [(e["ts"], e["ts"] + e["dur"]) for e in dev])) * 1e-6
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += e["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy, window_s=wall_s, device_ops=[list(o) for o in ops],
                device_op_s=dict(by_name))


def _ranges(events: list, prefix: str) -> list:
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith(prefix))


def _device_by_range(spans: list, dev: list, launch_ts: dict) -> tuple:
    """(device seconds, calls) by range name: each device operation counts
    to every range open on the host when its launch was issued."""
    starts = [s[0] for s in spans]
    calls = defaultdict(int)
    for _, _, name in spans:
        calls[name] += 1
    dev_s = defaultdict(float)
    for e in dev:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for a, b, name in spans[:bisect.bisect_right(starts, t)]:
            if a <= t <= b:
                dev_s[name] += e["dur"] * 1e-6
    return dict(dev_s), dict(calls)


def span_summary(events: list, top: int = 10) -> dict:
    """Device seconds and calls by harness range (span_device_s,
    span_calls) and by the program's range (program_device_s,
    program_calls), and the card's idle gaps inside the window by the
    innermost harness range open on the host."""
    spans = _ranges(events, "bench.")
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}

    def innermost(t):
        best = None
        for a, b, name in spans[:bisect.bisect_right(starts, t)]:
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else "harness"

    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev_s, calls = _device_by_range(spans, dev, launch_ts)
    prog_s, prog_calls = _device_by_range(_ranges(events, "tetra."), dev,
                                          launch_ts)
    window = [s for s in spans if s[2] == "bench.window"]
    gaps = defaultdict(float)
    if window:
        w0, w1, _ = window[0]
        busy = _union([(max(w0, e["ts"]), min(w1, e["ts"] + e["dur"]))
                       for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[innermost((a + b) / 2)] += (b - a) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return dict(span_device_s=dev_s, span_calls=calls,
                program_device_s=prog_s, program_calls=prog_calls,
                idle_gaps=[list(g) for g in idle])
