"""One run of one cell: set-up, the measured window, the traced stretches,
the correctness check and the metrics.

Everything a cell needs is found by name: the cell in BENCHMARK.json,
its configuration in configs/<config>.json, its traffic mix in
traffic/<traffic>.json, each metric's reader in metrics/<name>.py
(a module with read(run) -> number or None), and, where the
configuration names a "cell_module", that module in cells/<name>.py with
its limits in cells/<name>.json (see run_cell for its four calls).  The
program under test is tetra_tpu_torch's fleet receiver; nothing here
imports the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from .air import protocol as AP
from .air.synth import build_air, cells_of, cipher_arm

BENCH_DIR = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
PROFILE_DEVICE_SB = 4       # superblocks of the device stretch
PROFILE_SPAN_SB = 2         # superblocks of the span stretch
CAPTURES = 6                # superblocks whose decoded blocks are kept
CYCLE_CAPTURES = 3          # of them, those with one block's front end
DIBIT_CARRIERS = 64         # occupied carriers whose dibits are checked


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_path(root: str, *parts) -> str:
    """A file of the benchmark in the checkout at `root`."""
    return os.path.join(root, BENCH_DIR, *parts)


def load_reader(root: str, name: str):
    path = bench_path(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "tetra_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell_module(root: str, config: dict):
    """(module, limits) of the configuration's "cell_module", or (None,
    None) without one."""
    name = config.get("cell_module")
    if name is None:
        return None, None
    spec = importlib.util.spec_from_file_location(
        "tetra_bench.cells." + name, bench_path(root, "cells", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = bench_path(root, "cells", name + ".json")
    return mod, load_json(path) if os.path.exists(path) else {}


def _call(module, name: str, *args, default=None):
    """module.name(*args), or default where the module (or the call) is
    absent."""
    fn = getattr(module, name, None)
    return default if fn is None else fn(*args)


def cell_spec(root: str, workload: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, traffic) of a workload name."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(bench_path(root, "configs", cell["config"] + ".json"))
    traffic = load_json(bench_path(root, "traffic",
                                   cell["traffic"] + ".json"))
    return manifest, cell, config, traffic


def cell_air(config: dict, traffic: dict, seed: int, device, ext: int):
    """The cell's air from the seed: the occupied carriers (all, or the
    traffic's share chosen from the seed) and the periodic air on the
    device.  Returns (air, occupied)."""
    C = config["receiver"]["wideband"]
    occupied = np.zeros(C, bool)
    pick = np.random.default_rng([seed, 2]).choice(
        C, round(C * traffic["occupancy"]), replace=False)
    occupied[np.sort(pick)] = True
    air = build_air(C, cells_of(config["cells"]), occupied,
                    traffic["period_multiframes"], config["snr_db"],
                    config["cfo_max_hz"], seed, device, ext=ext,
                    voice=traffic.get("voice"), crypto=config.get("crypto"))
    return air, occupied


def metrics_of(manifest: dict, workload: str, kind: str) -> list:
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    carriers: int
    superblocks: int = 0
    air_s: float = 0.0          # seconds of air the window decoded
    wall_s: float = 0.0         # the window's wall
    delays_s: list = field(default_factory=list)
    setup_s: float = 0.0
    host_s: dict = field(default_factory=dict)   # layer -> window seconds
    calls: dict = field(default_factory=dict)
    device: dict = field(default_factory=dict)   # device stretch summary
    spans: dict = field(default_factory=dict)    # span stretch summary
    t50: int = 0
    t36: int = 0


class Feed:
    """The traffic's feed: one call of superblock() hands the receiver one
    superblock's air and returns when the receiver is done with it,
    giving the seconds from handing over its last sample to the return."""

    def __init__(self, kind: str, rx, air, probes):
        self.rx, self.air, self.probes = rx, air, probes
        wb = rx._wb
        self.K, self.adv, self.wide_len = rx.wb_k, wb["advance"], wb["wide_len"]
        self.pos = air.start            # next wide sample of the stream
        if kind == "staged":
            self.superblock = self._staged
        elif kind == "host":
            self.host = np.empty(len(air.re), np.complex64)
            self.host.real = air.re.cpu().numpy()
            self.host.imag = air.im.cpu().numpy()
            self.superblock = self._host
        else:
            raise ValueError(f"unknown feed {kind!r}")

    def _staged(self) -> float:
        o = self.pos % self.air.period
        shape, stride = (self.K, self.wide_len), (self.adv, 1)
        wr = self.air.re.as_strided(shape, stride, o).contiguous()
        wi = self.air.im.as_strided(shape, stride, o).contiguous()
        self.pos += self.K * self.adv
        t0 = time.perf_counter()
        self.rx.process_wideband_staged(wr, wi)
        return time.perf_counter() - t0

    def _host(self) -> float:
        steps = self.probes.steps
        while True:
            o = self.pos % self.air.period
            chunk = self.host[o:o + self.adv]
            self.pos += self.adv
            t0 = time.perf_counter()
            self.rx.process_wideband(chunk)
            dt = time.perf_counter() - t0
            if self.probes.steps > steps:
                return dt


def _chan_state(rx, c: int) -> tuple:
    """(slots, good blocks, lock losses, locked, MCC, MNC, colour code,
    (multiframe, frame, timeslot) of the last slot) of carrier c."""
    ch = rx.fleet.chan(c)
    d = ch.disp
    return (int(ch.slot_count), int(ch.crc_oks), int(ch.lock_losses),
            rx.locked(c), int(d.mcc), int(d.mnc), int(d.cc),
            (int(ch.time.mn), int(ch.time.fn), int(ch.time.tn)))


def _write_keystore(config: dict, seed: int):
    """The seeded keystore of the configuration's `crypto` in a temporary
    file; its path, or None without crypto."""
    _, text = cipher_arm(config.get("crypto"), cells_of(config["cells"]),
                         seed)
    if text is None:
        return None
    fd, path = tempfile.mkstemp(prefix="tetra_bench_", suffix=".keys")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    return path


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device=None) -> tuple[dict, list]:
    """One run.  Returns (result line without its check list, checks:
    [(name, value, limit)], value None where nothing could be compared,
    which fails).

    A configuration's cell module (load_cell_module) is called at four
    points, each call optional: receiver_kwargs(config, traffic,
    keystore_path) before the receiver is built, its dict merged into
    TetraReceiver's arguments (keystore_path: the seeded keystore of the
    configuration's `crypto` in a temporary file, else None);
    attach(rx, air, seed) before the warm-up, returning a state (its
    sinks run in the warm-up, the window and the traced stretches);
    collect(state, rx) after the traced stretches, before the receiver is
    freed, returning data off the card; checks(data, air, seed, limits)
    after the freeing, returning (name, value, limit) triples, appended
    to the harness's checks."""
    spec = cell_spec(root, workload)
    module, cell_limits = load_cell_module(root, spec[2])
    keystore = None if module is None else _write_keystore(spec[2], seed)
    try:
        return _run_cell(root, workload, spec, seed, seconds, trace,
                         t_start, device, module, cell_limits, keystore)
    finally:
        if keystore is not None:
            os.remove(keystore)


def _run_cell(root: str, workload: str, spec: tuple, seed: int,
              seconds: float, trace: bool, t_start: float, device, module,
              cell_limits, keystore) -> tuple[dict, list]:
    import torch
    from tetra_tpu_torch.rx.receiver import TetraReceiver

    from .probes import Probes
    from .reference import frontend as RF
    from .reference import truth

    marks = [time.perf_counter()]       # set-up by part, for stderr
    manifest, _, config, traffic = spec
    limits = load_json(bench_path(root, "limits.json"))
    dev = torch.device(device if device is not None else "cuda")
    C = config["receiver"]["wideband"]

    extra = _call(module, "receiver_kwargs", config, traffic, keystore,
                  default={})
    rx = TetraReceiver(**config["receiver"], **extra, fleet=True, device=dev)
    marks.append(time.perf_counter())
    wb = rx._wb
    K, adv, hop = rx.wb_k, wb["advance"], wb["hop"]
    air, occupied = cell_air(config, traffic, seed, dev,
                             ext=K * adv + wb["wide_len"] + 32 * hop)
    marks.append(time.perf_counter())
    probes = Probes(rx, timed=trace)
    feed = Feed(traffic["feed"], rx, air, probes)
    state = _call(module, "attach", rx, air, seed)
    marks.append(time.perf_counter())
    sb_air = K * adv / air.fs
    for _ in range(math.ceil(traffic["warmup_s"] / sb_air)):
        feed.superblock()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(time.perf_counter())
    print("setup s: start and imports {:.3f}, receiver {:.3f}, air {:.3f}, "
          "feed {:.3f}, warm-up {:.3f}".format(
              marks[0] - t_start, *np.diff(marks)), file=sys.stderr)

    # the window: back to back superblocks for `seconds`
    before = [_chan_state(rx, c) for c in range(C)]
    # decoded blocks kept from CAPTURES superblocks: the window's first
    # and others at seeded points spread over it; the first CYCLE_CAPTURES
    # of them with one block's front end and demod outputs (a seeded one)
    cap_rng = np.random.default_rng([seed, 3])
    targets = [0.0] + [(i + cap_rng.uniform()) / CAPTURES * seconds
                       for i in range(1, CAPTURES)]
    probes.take()
    run = Run(carriers=C, t50=wb["t50"], t36=wb["t36"])
    run.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    n_cap = 0
    while True:
        if n_cap < CAPTURES and time.perf_counter() - t0 >= targets[n_cap]:
            probes.capture_steps = {probes.steps}
            if n_cap < CYCLE_CAPTURES:
                probes.capture_cycles = {probes.cycles
                                         + int(cap_rng.integers(0, K))}
            n_cap += 1
        run.delays_s.append(feed.superblock())
        run.superblocks += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.wall_s = time.perf_counter() - t0
    run.air_s = run.superblocks * sb_air
    q = np.percentile(np.asarray(run.delays_s) * 1e3, [5, 50, 95, 100])
    print(f"window {run.superblocks} superblocks in {run.wall_s:.3f} s; "
          f"call ms p5 {q[0]:.2f} median {q[1]:.2f} p95 {q[2]:.2f} max "
          f"{q[3]:.2f}", file=sys.stderr)
    run.host_s, run.calls = probes.take()
    after = [_chan_state(rx, c) for c in range(C)]
    probes.capture_steps, probes.capture_cycles = set(), set()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if trace:
        from . import tracing
        ev, wall = tracing.profile(
            lambda: [feed.superblock() for _ in range(PROFILE_DEVICE_SB)],
            cpu=False)
        run.device = tracing.device_summary(ev, wall)
        ev, _ = tracing.profile(
            lambda: [feed.superblock() for _ in range(PROFILE_SPAN_SB)],
            cpu=True)
        run.spans = tracing.span_summary(ev)
        del ev
    data = _call(module, "collect", state, rx)

    # the program's outputs leave the device; its state is freed
    fe = {n: tuple(t.double().cpu() for t in v)
          for n, v in probes.frontend.items()}
    dm = {n: tuple(t.cpu().numpy() for t in v)
          for n, v in probes.demod.items()}
    rows = probes.rows
    probes.close()
    del rx, feed, probes, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference
    checks = []
    t36, t50 = wb["t36"], wb["t50"]
    err = 0.0
    for n, (pr, pi) in sorted(fe.items()):
        a = (air.start + n * adv - (RF.RS_TAPS - 1) * hop) % air.period
        rr, ri = RF.front_end(air.re[a:], air.im[a:], C, t50, t36,
                              torch.float64)
        rr, ri = rr.cpu(), ri.cpu()
        rms = float((rr.square() + ri.square()).mean().sqrt())
        err = max(err, float(max((pr - rr).abs().max(),
                                 (pi - ri).abs().max())) / rms)
    checks.append(("frontend_err", err if fe else None,
                   limits["frontend_err"]))

    occ = np.nonzero(occupied)[0]
    d_err = d_n = 0
    sym_per_wide = AP.SYMBOL_RATE / air.fs
    for n, (dib, val) in sorted(dm.items()):
        pick = np.sort(np.random.default_rng([seed, 4, n]).choice(
            occ, min(DIBIT_CARRIERS, len(occ)), replace=False))
        first_sym = ((air.start + n * adv) % air.period) * sym_per_wide
        e, m = truth.dibit_errors(dib, val, pick, air.cell_of, air.dibits,
                                  first_sym, t36 // 2)
        d_err, d_n = d_err + e, d_n + m
    checks.append(("dibit_errors", d_err if d_n else None,
                   limits["dibit_errors"]))

    wrong = good = chance = 0
    sent = truth.SentBlocks(air.records)
    notes = []
    for s_idx, parts in sorted(rows.items()):
        for r in parts:
            w, g, bad, n = truth.block_errors(r, air.cell_of, sent,
                                              air.period_slots)
            wrong, good, chance = wrong + w, good + g, chance + n
            notes += [f"superblock {s_idx}: " + truth.explain_row(
                r, i, air.cell_of, sent, air.period_slots)
                for i in bad[:max(0, 8 - len(notes))]]
    checks.append(("wrong_blocks", wrong if good else None,
                   limits["wrong_blocks"]))

    # the blocks expected of the slots each carrier consumed in the window
    # (at least the window's slots less one), from the slot after its
    # last one before the window, by the slot's record
    slots_nominal = int(run.air_s * AP.SYMBOL_RATE / AP.SYM_PER_TS) - 1
    attempted = failed = surplus = 0
    states = []
    for c in range(C):
        (s0, ok0, ll0, *_, t0), (s1, ok1, ll1, locked, mcc, mnc, cc, _) = \
            before[c], after[c]
        states.append((locked, mcc, mnc, cc, ll1 - ll0))
        if occupied[c]:
            p0 = int(truth.slot_of(*t0, air.period_slots)) + 1
            exp = truth.expected_blocks(sent, air.cell_of[c], p0,
                                        max(s1 - s0, slots_nominal))
            attempted += exp
            failed += max(0, exp - (ok1 - ok0))
            surplus += max(0, ok1 - ok0 - exp)
            if ok1 - ok0 != exp and len(notes) < 16:
                notes.append(f"carrier {c} (cell {air.cell_of[c]}, CFO "
                             f"{air.cfo_hz[c]:.1f} Hz): {s1 - s0} slots, "
                             f"{ok1 - ok0} good blocks of {exp} expected, "
                             f"{ll1 - ll0} lock losses")
    if sent.speech.max() >= 0:
        print(f"chance CRC passes on speech: {surplus} good blocks over "
              f"the expected (counters, window), {chance} in the captured "
              f"superblocks", file=sys.stderr)
    checks.append(("missed_blocks", failed if attempted else None,
                   limits["missed_blocks"]))
    checks.append(("display_errors",
                   truth.display_errors(states, air.cell_of, air.cells),
                   limits["display_errors"]))
    checks += [tuple(ch) for ch in _call(module, "checks", data, air, seed,
                                         cell_limits, default=[])]
    correct = all(v is not None and v <= lim for _, v, lim in checks)
    if not correct:
        for line in notes:
            print("note", line, file=sys.stderr)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, workload, kind):
        v = load_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = run.device.get("busy_s", 0.0)
        dev_info["window_s"] = run.device.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": run.device.get("device_ops", []),
                               "idle_gaps": run.spans.get("idle_gaps", [])}
    return result, checks
