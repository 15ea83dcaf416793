"""K4's FFT kernel at n_ch 512 and 1024 on the card: the built source
against variants of it that change its register pressure, each built
from an edited copy of tetra_tpu_torch/csrc under --out (by default in
the git-ignored build directory) and timed in turns (variants, then
again in reverse), each held to fold_dft_plain within
chip_smoke.TOL_FRONT_REL of its RMS.  The readings behind csrc/chan.cu's
launch bounds for FT = 8.

    PYTHONPATH=. python3 tests/torch_k4_variants.py

Variants: "built" (the source as it is), "two_blocks" (every FT at two
blocks an SM, so at most 128 registers a thread: FT = 8 spills),
"ft4_at_512" (n_ch = 512 takes the FT = 4 kernel).  Prints each build's
ptxas line for the FFT kernels, then the median, min and max event ms
of 9 x 20 launches per variant and n_ch.  Run it as a script (the H100
host has a `tests` package of its own)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

BOUNDS = ("__launch_bounds__(FFT_THREADS, FT == 8 ? 1 : 2)",
          "__launch_bounds__(FFT_THREADS, 2)")
FT8 = ("    if (n_ch == FFT_POINTS / 8)\n", "    if (n_ch == -1)\n")
VARIANTS = {"built": [], "two_blocks": [BOUNDS], "ft4_at_512": [FT8]}


def build(out: str, name: str, edits) -> ctypes.CDLL:
    from tetra_tpu_torch.ops import _build
    d = os.path.join(out, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("host"))
    path = os.path.join(d, "chan.cu")
    src = open(path).read()
    for a, b in edits:
        if a not in src:
            raise SystemExit(f"{name}: {a!r} not in chan.cu")
        src = src.replace(a, b)
    open(path, "w").write(src)
    so = os.path.join(d, "lib.so")
    srcs = sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".cu"))
    res = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                         + ["-o", so] + srcs, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    lines = (res.stdout + res.stderr).splitlines()
    print(name, json.dumps({
        lines[i].split("'")[1]: " | ".join(x.strip() for x in
                                           lines[i + 2:i + 4])
        for i, line in enumerate(lines)
        if "Compiling entry function" in line and "fold_fft" in line}),
        flush=True)
    lib = ctypes.CDLL(os.path.abspath(so))
    _build._declare(lib)
    return lib


def main() -> None:
    import chip_smoke as cs
    from tetra_tpu_torch import exact_float32
    from tetra_tpu_torch.ops import _build
    from tetra_tpu_torch.ops import chan_kernel as CK

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        "tetra_tpu_torch", "build", "k4_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    exact_float32()
    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    libs = {k: build(args.out, k, e) for k, e in VARIANTS.items()}

    def run(lib, zr, zi, n_ch):
        n_out = zr.shape[0] - (cs.CH.TAPS_PER_BRANCH * 2 - 1)
        a, n_s = CK._fold_args(zr, zi, n_ch)
        yr = torch.empty((n_out, n_ch), dtype=torch.float32, device=dev)
        yi = torch.empty_like(yr)
        _build.check(lib.launch_fold_dft(
            *a, yr.data_ptr(), yi.data_ptr(), n_out, n_ch, n_s,
            _build.stream_of(zr)), "fold_dft variant")
        return yr, yi

    for n_ch in (512, 1024):
        rng = np.random.default_rng(n_ch)
        rows = cs.T50 + 2 * cs.CH.TAPS_PER_BRANCH - 1
        zr, zi = (torch.from_numpy(rng.standard_normal(
            (rows, n_ch // 2)).astype(np.float32)).to(dev) for _ in "ri")
        yp = CK.fold_dft_plain(zr, zi, n_ch)
        rms = float(torch.sqrt((yp[0] ** 2 + yp[1] ** 2).mean()))
        times = {k: [] for k in VARIANTS}
        for k in list(VARIANTS) + list(VARIANTS)[::-1]:
            y = run(libs[k], zr, zi, n_ch)
            torch.cuda.synchronize()
            err = max(cs.maxerr(y[0], yp[0]), cs.maxerr(y[1], yp[1]))
            cs.check(err <= cs.TOL_FRONT_REL * rms,
                     f"{k} at n_ch={n_ch}: error {err} vs rms {rms}")
            times[k] += cs.batch_ms(lambda: run(libs[k], zr, zi, n_ch), 20,
                                    9)
        print(n_ch, json.dumps({k: dict(median=float(np.median(v)),
                                        min=min(v), max=max(v))
                                for k, v in times.items()}), flush=True)


if __name__ == "__main__":
    main()
