"""Where the wideband slices spend their time on one CUDA device.

    python3 -m tetra_tpu_torch.profile_slice

Runs the fleet slice of chip_smoke.py (TetraReceiver(wideband=256,
t50=6400, fleet=True, wb_k=8) over 6 s of synthesized 8-cell air) and
prints:

- host-clock time per superblock of each stage, over the superblocks after
  two warm-up ones: the device step (front end + K1 + K2 + packing, with a
  synchronize on both sides), the typed FEC (synchronized likewise), the
  fleet engine's whole call (feed + FEC + dispatch) and the superblock;
- a torch.profiler pass over one more superblock: device time by kernel
  (device rows only; an aten row repeats its kernels' time: the 20
  largest, and the port's own kernels wherever they rank) and the device
  busy share, kernel time over the superblock's wall time.

The stage timers synchronize, so the stage sum runs slower than the
untimed slice; the profiler pass runs slower again.

Then the same torch.profiler pass over two 128 ms cycles of chip_smoke.py's
per-channel slice (TetraReceiver(wideband=256, t50=6400, events=False),
fed host cf32 one cycle a call after 1.5 s of warm-up); its host-clock
stage times are chip_smoke.py's.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import exact_float32
from .ops import _build
from .rx import fec as FEC
from .rx import fleet as FL
from .rx import receiver as R
from .tx.wideband import cell_air, staged_windows

N_CH, T50, WB_K, AIR_SECONDS, N_CELLS, WARM = 256, 6400, 8, 6.0, 8, 2
# the port's kernels (csrc/*.cu), listed even outside the 20 largest rows
KERNELS = ("agc_fll_rrc_kernel", "mm_costas_kernel", "fold_fft_kernel",
           "fold_dft_kernel", "resample_kernel")


def _timed(owner, name: str, key: str, sync: bool, acc: dict) -> None:
    """Wrap owner.name so each call adds its host-clock time to acc[key]."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out

    setattr(owner, name, wrapper)


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_slice needs a CUDA device")
    exact_float32()
    _build.load()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rx = R.TetraReceiver(wideband=N_CH, t50=T50, fleet=True, wb_k=WB_K,
                         device=dev)
    wide = cell_air(N_CH, AIR_SECONDS, N_CELLS)
    staged = staged_windows(wide, rx._wb["advance"], rx._wb["wide_len"],
                            WB_K, dev)
    for s in range(WARM):
        rx.process_wideband_staged(*staged[s])
    torch.cuda.synchronize()

    acc = defaultdict(float)
    _timed(R, "_wideband_step_scan", "device step (synchronized)", True, acc)
    _timed(FEC, "decode_rows_typed_packed", "typed FEC (synchronized)", True,
           acc)
    _timed(FL.FleetEngine, "process_packed2", "fleet engine call", False, acc)
    _timed(R.TetraReceiver, "_superblock", "superblock", False, acc)
    timed = staged[WARM:-1]
    for wr, wi in timed:
        rx.process_wideband_staged(wr, wi)
    for key, sec in acc.items():
        print(f"stage {key}: {1e3 * sec / len(timed):.2f} ms/superblock "
              f"over {len(timed)}")

    _profile("profiled superblock",
             lambda: rx.process_wideband_staged(*staged[-1]))

    # the per-channel slice: one cycle a call
    rx = R.TetraReceiver(wideband=N_CH, t50=T50, events=False, device=dev)
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    warm = int(1.5 * N_CH * 25_000 / adv) + 1
    rx.process_wideband(wide[:wl - adv])
    for k in range(warm):
        rx.process_wideband(wide[wl - adv + k * adv:wl + k * adv])
    k = warm
    _profile("profiled per-channel cycles (2)",
             lambda: [rx.process_wideband(wide[wl - adv + j * adv:
                                               wl + j * adv])
                      for j in (k, k + 1)])


def _profile(label: str, fn) -> None:
    """One torch.profiler window around fn: its wall time, the device
    kernel time and busy share, and the largest device rows."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_ms(e) > 0]
    rows.sort(key=lambda e: -_device_ms(e))
    busy = sum(_device_ms(e) for e in rows)
    print(f"{label}: wall {wall_ms:.1f} ms, device kernel time "
          f"{busy:.1f} ms, busy share {busy / wall_ms:.3f}")
    # the 20 largest rows, then the port's own kernels below them
    own = [e for e in rows[20:] if any(k + "(" in e.key or k + "<" in e.key
                                       for k in KERNELS)]
    for e in rows[:20] + own:
        print(f"  {_device_ms(e):9.3f} ms  x{e.count:5d}  {e.key[:70]}")


if __name__ == "__main__":
    main()
