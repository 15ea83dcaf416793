"""The control of the correctness check: the reference put in the
program's place, one precision below the configuration's (bfloat16 for
float32).

plant() replaces the program's front end (parallel.channelizer.
_front_end_block, K3) by the reference's front end in bfloat16, computed
from the air of the block the receiver asks for; the program's stream
history passes on as it was.  Everything else of a run stays as it is,
and the run's own check (harness.run_cell) must come out as not
correct.  On the card at a cell's own size, a short window a seed:

    python3 tetra_bench/control.py --workload band256.full \
        --seeds 11 12 13 --seconds 5

prints each run's result line with its checks last, and exits non-zero
if any run came out correct; the benchmark's runs never plant it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(harness, set_attr=setattr) -> None:
    """Put the control in the program's place for the runs of `harness`
    (the tetra_bench.harness module that runs them).  set_attr is setattr
    or a test's monkeypatch.setattr."""
    import torch
    from tetra_tpu_torch.parallel import channelizer

    from .reference import frontend as RF

    state = {}
    make_air = harness.cell_air
    program = channelizer._front_end_block

    def cell_air(config, traffic, seed, device, ext):
        air, occupied = make_air(config, traffic, seed, device, ext)
        state.update(air=air, t50=config["receiver"]["t50"], blocks=0)
        return air, occupied

    def front_end_block(xr, xi, hr, hi, n_ch, t36):
        _, _, hr2, hi2 = program(xr, xi, hr, hi, n_ch, t36)
        air, t50, n = state["air"], state["t50"], state["blocks"]
        state["blocks"] = n + 1
        hop = n_ch // 2
        a = (air.start + n * t50 * hop - (RF.RS_TAPS - 1) * hop) % air.period
        rr, ri = RF.front_end(air.re[a:], air.im[a:], n_ch, t50, t36,
                              torch.bfloat16)
        return rr.float(), ri.float(), hr2, hi2

    set_attr(harness, "cell_air", cell_air)
    set_attr(channelizer, "_front_end_block", front_end_block)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the correctness control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tetra_bench import harness
    from tetra_bench.control import plant as plant_control
    plant_control(harness)
    passed = 0
    for seed in args.seeds:
        result, checks = harness.run_cell(ROOT, args.workload, seed,
                                          args.seconds, False,
                                          time.perf_counter())
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in checks}
        result["seed"] = seed
        passed += bool(result["correct"])
        print(json.dumps(result), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
