"""The mother-code trellis of rx/viterbi.viterbi_decode as one CUDA kernel
launch (csrc/fec_trellis.cu): every row of a call through the 16-state
forward pass and traceback, 4 mother bits a step (the control channels'
code) or 3 (the speech code), picked from the input's last dimension.
Its plain twin is rx/viterbi._viterbi, which viterbi_decode runs on CPU
tensors.

Soft-bit convention: +1 ~ bit 0, -1 ~ bit 1, 0 ~ punctured.  Each row
starts in state 0 and ends on its first best state (truncate) or on
state 0.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build

T_MAX = 288


@lru_cache(maxsize=2)
def _host_signs(nb: int) -> np.ndarray:
    """(2, nb, 16) float32: the sign of mother bit n on the transition into
    state ns from ns >> 1 ([0]) and from 8 + (ns >> 1) ([1]); the speech
    code's tables for nb = 3, the control code's for nb = 4."""
    # imported here: rx/viterbi, which holds the tables, imports this module
    from ..rx.viterbi import _acs_tables
    return np.ascontiguousarray(np.stack(_acs_tables(nb == 3)), np.float32)


def trellis(soft: torch.Tensor, truncate: bool) -> torch.Tensor:
    """soft (R, T, 3|4) contiguous float32 on a CUDA device, 0 < T <= T_MAX
    -> (R, T) uint8 decoded bits, in one kernel launch on the current
    stream.  Raises on any other input."""
    if soft.device.type != "cuda" or soft.dtype != torch.float32 \
            or soft.dim() != 3 or soft.shape[2] not in (3, 4) \
            or not soft.is_contiguous() or not 0 < soft.shape[1] <= T_MAX:
        raise ValueError(f"trellis: need contiguous float32 (R, T <= "
                         f"{T_MAX}, 3|4) on a CUDA device, got {soft.dtype} "
                         f"{tuple(soft.shape)} on {soft.device}")
    R, T, nb = soft.shape
    bits = torch.empty((R, T), dtype=torch.uint8, device=soft.device)
    err = _build.load().launch_fec_trellis(
        soft.data_ptr(), _host_signs(nb).ctypes.data, bits.data_ptr(), R, T,
        nb, int(truncate), _build.stream_of(soft))
    _build.check(err, "fec_trellis")
    trellis.launches += 1
    return bits


trellis.launches = 0            # fec trellis kernel launches
