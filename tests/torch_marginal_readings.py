"""Readings behind chip_smoke.py's slice_marginal decode shares: the fleet
receiver at the phase's shapes (t50 = 6400, wb_k = 8) on
tx.wideband.marginal_air, one JSON line per carrier with its SNR, whether
it is a handover carrier, whether it is locked at the end, its lock
losses, the cell it adopted (a CRC-checked SYNC PDU: "own", "new", "none"
or "false") and its CRC tallies, then one line of shares per SNR band.

    PYTHONPATH=. python3 tests/torch_marginal_readings.py --carriers 32 \
        --seeds 0 1

from the repository's root.  Runs on the CPU by default (no jax), ~10 s
of receiver time a seed at 32 carriers; --device cuda runs it on the
card.

    PYTHONPATH=. python3 tests/torch_marginal_readings.py --card-vs-cpu \
        --seeds 11 12 13

(on the card) gives the readings behind slice_marginal's card-vs-CPU
rule instead: chip_smoke.marginal_card_vs_cpu at 256 carriers from the
fleet receiver's state after 1, 2 and 3 superblocks of each seed's air,
with every channel that differs recorded (K2_AXIS_EPS = 1, no gate):
per cycle the chain's identical share, K1's mf error, and for each
differing channel of K2 alone its least axis distance and leak gap."""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import handover_cell, marginal_air


def readings(n_ch: int, seed: int, device) -> list[dict]:
    import chip_smoke as cs

    wide, plan = marginal_air(n_ch, cs.MARGINAL_SECONDS,
                              cs.MARGINAL_DROPOUT_AT, seed=seed,
                              device=device)
    rx = TetraReceiver(wideband=n_ch, t50=6400, fleet=True, wb_k=8,
                       device=device)
    rx.process_wideband(wide)
    rows = []
    for c in range(n_ch):
        ch = rx.fleet.chan(c)
        cell = (ch.cell_mcc, ch.cell_mnc, ch.cell_cc)
        i = int(plan["cell"][c])
        kind = {(262, 100 + i, 1 + i): "own", (0, 0, 0): "none"}
        if plan["handover"][c]:
            new = handover_cell(int(plan["new_cell"][c]))
            kind[(new.mcc, new.mnc, new.cc)] = "new"
        rows.append(dict(seed=seed, carrier=c,
                         snr_db=float(plan["snr_db"][c]),
                         handover=bool(plan["handover"][c]),
                         locked=rx.locked(c),
                         lock_losses=rx.fleet.lock_losses(c),
                         cell=kind.get(cell, "false"),
                         crc=list(rx.crc_counts(c))))
    return rows


def card_vs_cpu(seeds) -> None:
    import chip_smoke as cs
    from tetra_tpu_torch import exact_float32
    from tetra_tpu_torch.tx.wideband import staged_windows

    exact_float32()
    cs.K2_AXIS_EPS = cs.K2_AXIS_SHARE = 1.0
    dev = torch.device("cuda", 0)
    ax, leak, per_cycle, chain = [], [], [], []
    for seed in seeds:
        wide, _ = marginal_air(cs.N_CH, cs.MARGINAL_SECONDS,
                               cs.MARGINAL_DROPOUT_AT, seed=seed, device=dev)
        rx = TetraReceiver(wideband=cs.N_CH, t50=cs.T50, fleet=True,
                           wb_k=cs.WB_K, device=dev)
        staged = staged_windows(wide, rx._wb["advance"], rx._wb["wide_len"],
                                cs.WB_K, dev)
        for s, sb in enumerate(staged[:4]):
            if s:
                fails = []
                r = cs.marginal_card_vs_cpu(
                    rx.state, (rx._wb["hist_r"], rx._wb["hist_i"]), sb,
                    gate=lambda ok, what: ok or fails.append(what))
                for c in r["cycles"]:
                    sw = c["k2_switched"].values()
                    ax += [v["axis"] for v in sw]
                    leak += [v["leak_gap"] for v in sw]
                    per_cycle.append(len(c["k2_switched"]))
                    chain.append(c["chain_channels_identical"])
                print(json.dumps(dict(
                    seed=seed, superblock=s, failures=fails,
                    k1_mf_max_abs_err=r["k1_mf_max_abs_err_max"],
                    chain=[c["chain_channels_identical"]
                           for c in r["cycles"]],
                    k2_switched=[c["k2_switched"] for c in r["cycles"]])))
            rx.process_wideband_staged(*sb)
    ax, leak = np.asarray(ax), np.asarray(leak)
    by_leak = leak <= cs.K2_LEAK_EPS
    print(json.dumps(dict(
        gpu=cs.gpu_line(), cycles=len(per_cycle), differing=len(ax),
        by_leak=int(by_leak.sum()),
        leak_gap_max=float(leak[by_leak].max()) if by_leak.any() else None,
        by_axis=int((~by_leak).sum()),
        axis_max=float(ax[~by_leak].max()) if (~by_leak).any() else None,
        switched_max_per_cycle=max(per_cycle),
        chain_min=min(chain), chain_max=max(chain))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--carriers", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--card-vs-cpu", action="store_true",
                    help="slice_marginal's card-vs-CPU readings (a card)")
    args = ap.parse_args(argv)
    if args.card_vs_cpu:
        return card_vs_cpu(args.seeds)
    torch.set_num_threads(1)
    rows = []
    for seed in args.seeds:
        rows += readings(args.carriers, seed, args.device)
    for r in rows:
        print(json.dumps(r))
    bands = {}
    for lo, hi in ((7.5, 10.0), (10.0, 12.0)):
        sel = [r for r in rows if not r["handover"]
               and lo <= r["snr_db"] <= hi]
        bands[f"{lo:g}-{hi:g} dB"] = dict(
            carriers=len(sel),
            own_cell=sum(r["cell"] == "own" for r in sel),
            locked=sum(r["locked"] for r in sel))
    ho = [r for r in rows if r["handover"]]
    bands["handover"] = dict(carriers=len(ho),
                             new_cell=sum(r["cell"] == "new" for r in ho),
                             locked=sum(r["locked"] for r in ho))
    bands["false_cell"] = sum(r["cell"] == "false" for r in rows)
    print(json.dumps(dict(bands=bands, seeds=args.seeds,
                          carriers=args.carriers,
                          mean_snr=float(np.mean([r["snr_db"]
                                                  for r in rows])))))


if __name__ == "__main__":
    main()
