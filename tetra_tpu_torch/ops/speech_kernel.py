"""The voice monitor's speech trellis (csrc/speech_trellis.cu): the rows
of a superblock's batched speech decode (voice/speech_batch.py) through
the 16-state rate-1/3 speech mother code, on CUDA tensors in one kernel
launch, on CPU tensors in its plain PyTorch version (one add-compare-
select step of every row at a time).

Soft-bit convention: +1 ~ bit 0, -1 ~ bit 1, 0 ~ punctured.  Each row
starts in state 0 and ends on its best state (truncated) or on state 0.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..rx.viterbi import _acs_tables
from . import _build

N_STATES = 16
T_MAX = 112
_NEG = -1e9


@lru_cache(maxsize=1)
def _host_signs() -> np.ndarray:
    """(2, 3, 16) float32: the sign of mother bit n on the transition into
    state ns from ns >> 1 ([0]) and from 8 + (ns >> 1) ([1])."""
    return np.ascontiguousarray(np.stack(_acs_tables(True)), np.float32)


def trellis_plain(x: torch.Tensor, truncate: torch.Tensor) -> torch.Tensor:
    """x (R, T, 3) float32 soft mother symbols -> (R, T) uint8 bits; row r
    ends on its best state where truncate[r], else on state 0."""
    R, T, _ = x.shape
    dev = x.device
    E0t, E1t = (torch.from_numpy(e).to(dev) for e in _host_signs())
    # branch metrics term by term, left to right, as the kernel forms them
    bm0 = x[..., 0:1] * E0t[0] + x[..., 1:2] * E0t[1] + x[..., 2:3] * E0t[2]
    bm1 = x[..., 0:1] * E1t[0] + x[..., 1:2] * E1t[1] + x[..., 2:3] * E1t[2]
    bitw = (1 << torch.arange(N_STATES, dtype=torch.int32, device=dev))[None]
    metrics = torch.full((R, N_STATES), _NEG, dtype=torch.float32,
                         device=dev)
    metrics[:, 0] = 0.0
    decisions = torch.empty((T, R), dtype=torch.int32, device=dev)
    for t in range(T):
        cand0 = metrics[:, :8].repeat_interleave(2, dim=1) + bm0[:, t]
        cand1 = metrics[:, 8:].repeat_interleave(2, dim=1) + bm1[:, t]
        take1 = cand1 > cand0
        new = torch.where(take1, cand1, cand0)
        metrics = new - new.max(dim=1, keepdim=True).values
        decisions[t] = torch.where(take1, bitw, 0).sum(dim=1,
                                                       dtype=torch.int32)
    state = torch.where(truncate.bool(),
                        metrics.argmax(dim=1).to(torch.int32),
                        torch.zeros((), dtype=torch.int32, device=dev))
    bits = torch.empty((R, T), dtype=torch.uint8, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        took1 = ((decisions[t] >> state) & 1) == 1
        state = torch.where(took1, (state >> 1) + 8, state >> 1)
    return bits


def trellis(x: torch.Tensor, truncate: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, trellis_plain on CPU tensors (same
    signature and output)."""
    if x.device.type == "cpu":
        return trellis_plain(x, truncate)
    if x.device.type != "cuda":
        raise ValueError(f"trellis: unsupported device {x.device}")
    R, T, n = x.shape
    if x.dtype != torch.float32 or n != 3 or not x.is_contiguous() \
            or not 0 < T <= T_MAX:
        raise ValueError(f"trellis: need contiguous float32 (R, T <= "
                         f"{T_MAX}, 3), got {x.dtype} {tuple(x.shape)}")
    if truncate.dtype != torch.bool or tuple(truncate.shape) != (R,) \
            or truncate.device != x.device:
        raise ValueError("trellis: truncate must be (R,) bool on x's device")
    bits = torch.empty((R, T), dtype=torch.uint8, device=x.device)
    err = _build.load().launch_speech_trellis(
        x.data_ptr(), truncate.contiguous().data_ptr(),
        _host_signs().ctypes.data, bits.data_ptr(), R, T,
        _build.stream_of(x))
    _build.check(err, "speech_trellis")
    trellis.launches += 1
    return bits


trellis.launches = 0            # speech trellis kernel launches
