"""tetra_tpu_torch: the TETRA downlink receiver ported to PyTorch and CUDA.

The JAX package `tetra_tpu` is the reference this port is held against.
The port imports `torch` and nothing of `jax` or `tetra_tpu`: it keeps its
own copies of the host-only modules it needs (params, core.taps,
rx.tdma/display/native_mac/mac_pdu/llc/mle, tx.cell/burst/fec_enc,
crypto.*) and of the native C++ sources: the fleet engine, the MAC core
and the ACELP codec (csrc/host/).

Every hand-written CUDA kernel lives under `csrc/` and is built with nvcc on
first use (ops/_build.py).  Each kernel's wrapper runs the kernel on CUDA
tensors and its plain PyTorch version on CPU tensors, never falling back
from one to the other.  Public entry points run on the current CUDA device
unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device a public entry point runs on: the current CUDA device by
    default (None or "cuda"), "cuda:N", or "cpu" when the caller asks for
    it.  Raises when CUDA is asked for, by default too, and unavailable: it
    never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def exact_float32() -> None:
    """Keep every float32 matmul and convolution at full float32 precision
    (TF32 off), as the comparisons against the JAX reference assume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
