"""Multi-host wideband receiver bring-up (torch.distributed launcher; port
of tetra_tpu/apps/multihost.py).

Run ONE copy of this program per host: each host ingests its own wideband
antenna feed, and channels never cross hosts, so samples/s scales with
hosts (parallel/mesh.py):

    python -m tetra_tpu_torch.apps.multihost --coordinator host0:29500 \\
        --num-processes 4 --process-id $RANK capture_$RANK.c64 --channels 16

Each launcher starts one rank per chip (--chips, default: the host's card
count), rank = host * chips + chip, on card cuda:chip; the ranks form the
2-D (host, chip) mesh over torch.distributed.  Every flag defaults to one
process, so the same entry point serves bring-up on one box: without
--coordinator and with --hosts above --num-processes, one launcher starts
every host's ranks itself (their chips share the box's cards), e.g. the
one-card rehearsal

    python -m tetra_tpu_torch.apps.multihost --hosts 2 --chips 1 \\
        --channels 256 --selftest --backend gloo

and on the CPU: --device cpu --backend gloo.  --backend nccl needs a card
per rank; gloo serves ranks that share a card or run on the CPU (the
default picks nccl when every local rank has a card of its own).

Per rank and step: K4 over the host's whole band, the resample kernel on
the rank's channels, K1 and K2 (full form); the only traffic between ranks
is the all-reduced fleet health scalar.  Each rank then runs burst sync
and the batched FEC + MAC stack on its own channels (the reference's
per-host stacks, split per rank: channels are independent) and prints its
lock and decode status.  --selftest synthesizes one TETRA cell on carrier
3 of each host and checks its decode at the end.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def _build_parser():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("input", nargs="?", default=None,
                    help="this host's raw complex64 wideband IQ file "
                         "(omit with --selftest)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous address of rank 0's host (omit for "
                         "one launcher)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="launchers (hosts' copies of this program)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--channels", type=int, default=16,
                    help="25 kHz channels per host (input rate = "
                         "channels*25 kHz)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="host-axis size (default: num-processes; set "
                         "higher to rehearse a multi-host mesh on one box)")
    ap.add_argument("--chips", type=int, default=None,
                    help="chip-axis size (default: the host's card count, "
                         "1 on the CPU)")
    ap.add_argument("--t50", type=int, default=6400,
                    help="50 kHz samples per step per channel")
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = until input ends)")
    ap.add_argument("--status-every", type=int, default=5,
                    help="print status every N steps")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize one TETRA cell per host instead of "
                         "reading input, and validate decode at the end")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: rank chip on cuda:chip) or "
                         "'cpu'")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default: nccl when "
                         "every local rank has a card of its own, else "
                         "gloo)")
    return ap


def say(line: str) -> None:
    """One whole line to stdout in one write: the ranks share the pipe."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _selftest_air(h: int, n_ch: int, device):
    """Host h's synthetic feed on `device`: CellConfig(mcc=200+h,
    mnc=100+h, cc=1+h) on carrier 3, 15 dB SNR, 150 Hz CFO, noise from a
    torch.Generator seeded with h.  Returns (complex64 tensor, config)."""
    import torch

    from ..rx.tdma import TdmaTime
    from ..tx import cell
    from ..tx.channel import channel as tx_channel
    from ..tx.modulator import modulate
    from ..tx.wideband import assemble_wideband

    cfg = cell.CellConfig(mcc=200 + h, mnc=100 + h, cc=1 + h)
    bits, _ = cell.downlink_bits(cfg, 200, start=TdmaTime(mn=1, fn=17, tn=4))
    x = modulate(bits[None, :], device=device)[0].cpu().numpy()
    wide = assemble_wideband({3: x}, n_ch, amplitude=0.5, device=device)
    gen = torch.Generator(device=device).manual_seed(h)
    return tx_channel(wide, gen, snr_db=15.0, cfo_hz=150.0,
                      sample_rate=float(n_ch * 25_000), device=device), cfg


def _rank_main(args, rank: int, world: int, h: int, chip: int, device,
               backend: str, init_method: str) -> None:
    """One rank: join the group, run the mesh, exit 1 on a failed
    selftest."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    device = init_distributed(backend, init_method, world, rank, device)
    try:
        code = _run(args, h, chip, device, backend)
    finally:
        dist.destroy_process_group()
    sys.exit(code)


def _run(args, h: int, chip: int, device, backend: str) -> int:
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import (host_channels, make_mesh_2d,
                                 sharded_wideband_demod_init,
                                 sharded_wideband_demod_step)
    from ..rx.burst_sync import RX_LOCKED, BurstSync
    from ..rx.demod import dibits_to_bits
    from ..rx.lower_mac import LowerMac, process_bursts_multi
    from ..rx.tdma import PhyState

    n_hosts, n_chips, n_ch = args.hosts, args.chips, args.channels
    mesh = make_mesh_2d(n_hosts, n_chips, device)
    step, wide_len, advance = sharded_wideband_demod_step(mesh, n_ch,
                                                          t50_new=args.t50)
    state = sharded_wideband_demod_init(mesh, n_ch, device)
    _, c0, count = host_channels(mesh, n_ch)
    j0 = c0 - h * n_ch
    tag = f"[host {h} chip {chip}]"
    fs = n_ch * 25_000
    if chip == 0:
        say(f"[host {h}] mesh (host={n_hosts}, chip={n_chips}), "
            f"{n_ch} ch/host @ {fs/1e6:.1f} MS/s, window {wide_len} "
            f"(+{advance}/step), {backend}")

    if args.selftest:
        wide, want = _selftest_air(h, n_ch, device)
        total_raw = wide.shape[0]

        def window(s0):
            w = wide[s0:s0 + wide_len]
            return w.real.contiguous(), w.imag.contiguous()
    else:
        raw = np.fromfile(args.input, np.complex64)
        total_raw = len(raw)

        def window(s0):
            w = raw[s0:s0 + wide_len]
            return tuple(torch.from_numpy(np.ascontiguousarray(
                p, np.float32)).to(device) for p in (w.real, w.imag))

    n_steps = (total_raw - wide_len) // advance + 1
    if args.steps:
        n_steps = min(n_steps, args.steps)
    # every rank runs the same steps: the step's all-reduce is collective
    n = torch.tensor(n_steps, device=device)
    dist.all_reduce(n, op=dist.ReduceOp.MIN)
    n_steps = int(n)

    phys = [PhyState() for _ in range(count)]
    syncs = [BurstSync(phy=p) for p in phys]
    macs = [LowerMac(phy=p, device=device) for p in phys]
    t0 = time.time()
    fleet_dist = float("nan")
    for it in range(n_steps):
        wr, wi = window(it * advance)
        state, outs, _ = step(state, wr, wi)
        fleet_dist = float(outs["fleet_dist"])
        dib = outs["dibits"].cpu().numpy()
        val = outs["valid"].cpu().numpy()
        feed_macs, feed_bursts = [], []
        for c in range(count):
            v = val[c]
            if not v.any():
                continue
            bursts = syncs[c].feed(dibits_to_bits(dib[c][v]))
            if bursts:
                feed_macs.append(macs[c])
                feed_bursts.append(bursts)
        if feed_macs:
            process_bursts_multi(feed_macs, feed_bursts)
        if args.status_every and (it + 1) % args.status_every == 0:
            locked = sum(s.state == RX_LOCKED for s in syncs)
            crc_ok = sum(m.crc_oks for m in macs)
            rate = (it + 1) * advance / (time.time() - t0)
            say(f"{tag} step {it+1}/{n_steps} locked {locked}/{count} "
                f"crc_ok {crc_ok} fleet_dist {fleet_dist:.3f} "
                f"{rate/1e6:.1f} MS/s/host")

    wall = time.time() - t0
    locked = sum(s.state == RX_LOCKED for s in syncs)
    crc_ok = sum(m.crc_oks for m in macs)
    say(f"{tag} done: {n_steps} steps, channels {c0}..{c0 + count - 1}, "
        f"locked {locked}, crc_ok {crc_ok}, fleet_dist {fleet_dist:.3f}, "
        f"{n_steps*advance/wall/1e6:.1f} MS/s/host in {wall:.2f} s")
    if not args.selftest or not j0 <= 3 < j0 + count:
        return 0
    # the rank that owns the host's carrier 3 checks its cell
    m = macs[3 - j0]
    d = m.upper.display
    good = (d.mcc, d.mnc, d.cc) == (want.mcc, want.mnc, want.cc)
    say(f"[host {h}] row {h} ch3: mcc/mnc/cc = {d.mcc}/{d.mnc}/{d.cc} "
        f"({'OK' if good else 'MISMATCH'}), crc_ok {m.crc_oks}")
    ok = good and m.crc_oks > 40
    say(f"[host {h}] SELFTEST {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def _supervise(procs: list) -> int:
    """Wait for the ranks; once one fails, stop the others (they would wait
    in a collective).  Returns 0, or the first failing exit code."""
    code = 0
    while any(p.is_alive() for p in procs):
        for p in procs:
            p.join(timeout=0.2)
            if p.exitcode not in (None, 0) and code == 0:
                code = p.exitcode
                for q in procs:
                    if q.is_alive():
                        q.terminate()
    for p in procs:
        p.join()
        if p.exitcode != 0 and code == 0:
            code = p.exitcode
    return code if code >= 0 else 1


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.input is None and not args.selftest:
        print("error: need an input file or --selftest", file=sys.stderr)
        return 2

    import torch

    from .. import resolve_device
    from ..parallel.mesh import check_backend

    dev_type = resolve_device(args.device).type
    args.hosts = args.hosts or args.num_processes
    args.chips = args.chips or (torch.cuda.device_count()
                                if dev_type == "cuda" else 1)
    if args.hosts % args.num_processes:
        print(f"error: {args.hosts} hosts over {args.num_processes} "
              f"launchers", file=sys.stderr)
        return 2
    per = args.hosts // args.num_processes
    local = [(h, c) for h in range(args.process_id * per,
                                   (args.process_id + 1) * per)
             for c in range(args.chips)]
    devices = [torch.device("cpu") if dev_type == "cpu"
               else torch.device("cuda", c) for _, c in local]
    backend = args.backend
    if backend is None:
        backend = "gloo"
        if dev_type == "cuda":
            try:
                check_backend("nccl", devices)
                backend = "nccl"
            except ValueError:
                pass
    check_backend(backend, devices)

    world = args.hosts * args.chips
    tmp = None
    if args.coordinator is not None:
        init_method = f"tcp://{args.coordinator}"
    else:
        # every rank is on this box: rendezvous in a file, gloo over the
        # loopback (the ranks inherit the environment)
        tmp = tempfile.mkdtemp(prefix="tetra_multihost_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(args, h * args.chips + c, world, h, c, d,
                               backend, init_method))
             for (h, c), d in zip(local, devices)]
    try:
        for p in procs:
            p.start()
        return _supervise(procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
