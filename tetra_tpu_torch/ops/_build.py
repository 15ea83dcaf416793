"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Every kernel source is compiled on first use into ONE shared library with a
plain C interface (no PyTorch headers: a build takes seconds, not minutes),
named by the hash of the sources so an edited source never loads a stale
library.  The library is written under a temporary name and moved into
place with os.replace, so concurrent processes never load a half-written
file.  Output goes to tetra_tpu_torch/build/ (listed in .gitignore).

Each launcher takes device pointers and the CUDA stream as void*, launches
on that stream without synchronising, and returns the cudaError_t of the
launch; `check` raises on a non-zero code.

host_library builds the host C++ libraries (csrc/host/: the fleet engine,
the native MAC core) with g++ the same way.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no implicit mul+add contraction: the kernels round like their
              # plain PyTorch versions; hot loops use fmaf() explicitly
              "-fmad=false", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
build_seconds = 0.0          # wall time of the nvcc build in this process


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return exe


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtetra_kernels_{h.hexdigest()[:16]}.so")


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # x(2), state(3), hist(2), taps (host), offs (host) | Kd |
    # mf(2), state(3), hist(2) | T, C |
    # r_eff, setpoint, squelch, max_gain, beta_d, freq_lim | stream
    lib.launch_agc_fll_rrc.argtypes = (
        [P] * 9 + [I] + [P] * 7 + [I, I] + [F] * 6 + [P])
    # mf(2), tail(2), st0, polys (host), sym(2), dib, val, dist, st_out |
    # T, C, n_groups, G | 9 gains/limits | stream
    lib.launch_mm_costas.argtypes = [P] * 12 + [I] * 4 + [F] * 9 + [P]
    # z(2), F, twiddles, Wt(2), y(2) | n_out, n_ch, n_s | stream
    lib.launch_fold_dft.argtypes = [P] * 8 + [I] * 3 + [P]
    # x(2), hist(2), coef, off, y(2), tails(2) | t_in, t_out, C | stream
    lib.launch_resample.argtypes = [P] * 10 + [I] * 3 + [P]
    # z(2), F, twiddles, Wt(2), scratch y(2), hist(2), coef, off, out(2),
    # tails(2) | n_out, n_ch, n_s, t_out | stream
    lib.launch_fold_dft_resample.argtypes = [P] * 16 + [I] * 4 + [P]
    # x, truncate, signs (host), bits | R, T | stream
    lib.launch_speech_trellis.argtypes = [P] * 4 + [I] * 2 + [P]
    # x, signs (host), bits | R, T, nb, truncate | stream
    lib.launch_fec_trellis.argtypes = [P] * 3 + [I] * 4 + [P]
    # frames, bfi, kind, order, seg, keys | n_calls | pool, tables, pcm |
    # state_bytes, table_bytes | stream
    lib.launch_acelp_synth.argtypes = [P] * 6 + [I] + [P] * 3 + [I] * 2 + [P]
    for name in ("launch_agc_fll_rrc", "launch_mm_costas",
                 "launch_fold_dft", "launch_resample",
                 "launch_fold_dft_resample", "launch_speech_trellis",
                 "launch_fec_trellis", "launch_acelp_synth"):
        getattr(lib, name).restype = ctypes.c_int


def load():
    """The loaded kernel library, built from csrc/ on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                res = subprocess.run(
                    [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + _sources(),
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError("nvcc failed:\n" + res.stdout
                                       + res.stderr)
                with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
                    f.write(res.stdout + res.stderr)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return lib


def host_library(stem: str, srcs: list[str], flags: list[str],
                 libs: tuple[str, ...] = ()) -> str:
    """Path of the host (g++) shared library built from srcs[0], which
    includes srcs[1:], by `g++ <flags> -shared -fPIC -o <so> srcs[0]
    <libs>` (each caller passes its JAX counterpart's flags, so both builds
    compute alike).  It is
    built on first use under a name hashed from the sources and flags,
    written under a temporary name and moved into place as the CUDA
    library is.  A failed build raises."""
    cmd = ["g++"] + flags + ["-shared", "-fPIC"]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags + list(libs)).encode())
    so = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(cmd + ["-o", tmp, srcs[0], *libs], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    """The current CUDA stream of t's device, as a pointer: read directly,
    without building the torch.cuda.Stream object that
    torch.cuda.current_stream(...).cuda_stream builds on every call."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)
