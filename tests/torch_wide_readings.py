"""K1 and K2 against their plain versions at the wide demod widths, on the
card, from several warm states: the readings behind chip_smoke.py's
TOL_K1_MF_WIDE (slice_wide).

    PYTHONPATH=. python3 tests/torch_wide_readings.py --seeds 2 3 4

For each seed, heterogeneous_fleet_iq(WARM_BLOCKS + 1, WIDE_DEMOD_C,
T_DEMOD, seed) runs WARM_BLOCKS blocks through the kernel chain; then, at
each of WIDE_K12_C channels (the first C of them), the next block goes to
K1 and its plain version from that state, then K2 on K1's output under
k2_check's marginal-SNR rule (chip_smoke.demod_rows, every check
recorded, none raised; the K1 limits at 0, so the readings are the
errors themselves).  Prints one JSON line per (seed, C) and a
summary line.  Run it as a script (the H100 host has a `tests` package of
its own).

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tests/torch_wide_readings.py \
        --cpu-demod --seeds 5 6 7 8

On the CPU, with tetra_tpu installed: the readings behind
tests/test_torch_wide.py's demod limits (MAX_PARTED, FLOAT_MAX,
STATE_MAX): its demod_readings on heterogeneous_fleet_iq(2, 1024, 4608,
seed) for each seed, one JSON line per (seed, block) and the largest of
each reading."""

from __future__ import annotations

import argparse
import json

import torch


def cpu_demod(seeds: list) -> None:
    from tests.test_torch_wide import demod_readings
    from tetra_tpu_torch.tx.wideband import heterogeneous_fleet_iq

    torch.set_num_threads(1)
    worst = {}
    for seed in seeds:
        xr, xi = heterogeneous_fleet_iq(2, 1024, 4608, seed=seed)
        for r in demod_readings(xr, xi):
            print(json.dumps(dict(seed=seed, **r)), flush=True)
            for k in ("k1_mf_err", "k1_state_err", "k2_float_err",
                      "chain_float_err", "state_err"):
                worst[k] = max(worst.get(k, 0.0), r[k])
            for k in ("k2_partings", "k1_into_k2_partings", "chain_parted",
                      "k2_unexplained", "k1_into_k2_unexplained"):
                worst[k] = max(worst.get(k, 0), len(r[k]))
            worst["drift"] = max([worst.get("drift", 0.0)] + [
                v["drift"] for k in ("k2_partings", "k1_into_k2_partings")
                for v in r[k].values()])
            for k in ("k2_float_close", "chain_float_close"):
                worst[k] = min(worst.get(k, 1.0), r[k])
    print(json.dumps(dict(worst=worst)), flush=True)


def main() -> None:
    import chip_smoke as cs
    from tetra_tpu_torch import exact_float32
    from tetra_tpu_torch.tx.wideband import heterogeneous_fleet_iq

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--cpu-demod", action="store_true")
    args = ap.parse_args()
    if args.cpu_demod:
        return cpu_demod(args.seeds)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    exact_float32()
    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    worst = {}
    for seed in args.seeds:
        xr, xi = heterogeneous_fleet_iq(cs.WARM_BLOCKS + 1, cs.WIDE_DEMOD_C,
                                        cs.T_DEMOD, seed=seed)
        state = cs.warm_demod(dev, xr, xi, cs.WARM_BLOCKS)
        for c in cs.WIDE_K12_C:
            failed = []
            st = type(state)(*(t[:c].contiguous() for t in state))
            x_r = torch.from_numpy(xr[cs.WARM_BLOCKS, :c].T.copy()).to(dev)
            x_i = torch.from_numpy(xi[cs.WARM_BLOCKS, :c].T.copy()).to(dev)
            rows, _ = cs.demod_rows(
                st, x_r, x_i, 0.0, f"K2 at C={c}",
                gate=lambda ok, what: ok or failed.append(what),
                tol_state=0.0, axis_eps=cs.K2_AXIS_EPS)
            k1, k2 = rows
            out = dict(seed=seed, channels=c, k1_mf_err=k1["max_abs_err"],
                       k1_state_err=k1["state_err"],
                       k2_channels_identical=k2["channels_identical"],
                       k2_max_abs_err=k2["max_abs_err"],
                       k2_leak_stepped=len(k2["leak_stepped"]),
                       k2_switched={ch: v["by"] for ch, v in
                                    k2["switched"].items()},
                       k2_unexplained=k2["unexplained"],
                       failed=[f for f in failed
                               if not f.startswith(f"K1 at C={c}")])
            worst[c] = max(worst.get(c, 0.0), out["k1_mf_err"])
            print(json.dumps(out), flush=True)
    print(json.dumps(dict(k1_mf_err_max=worst)), flush=True)


if __name__ == "__main__":
    main()
