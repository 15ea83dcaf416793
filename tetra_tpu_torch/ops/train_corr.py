"""Batched training-sequence correlation on a torch device (port of
tetra_tpu/ops/train_corr.py).

Device-side half of wideband burst sync: the bit-serial rolling matcher of
phy/tetra_burst.c:271-341 becomes one correlation per training sequence
over (channels, bits) blocks, giving exact-match positions for every
channel in one call.  The host lock state machine (rx/burst_sync.py)
consumes the hit masks.  In the JAX package this is an XLA convolution,
not a Pallas kernel, so it stays F.conv1d here (core/fir._conv_valid_real).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from .. import resolve_device
from ..core.fir import _conv_valid_real


@lru_cache(maxsize=1)
def _seq_kernels():
    """(seq_id, length, +-1 kernel) for the three downlink-relevant
    sequences, kernels reversed for convolution-as-correlation."""
    out = []
    for sid in (P.TRAIN_SEQ_SYNC, P.TRAIN_SEQ_NORM_1, P.TRAIN_SEQ_NORM_2):
        seq = P.TRAIN_SEQS[sid].astype(np.float32)
        k = (1.0 - 2.0 * seq)[::-1].copy()
        out.append((sid, len(seq), k))
    return tuple(out)


def train_seq_hits(bits: torch.Tensor) -> dict:
    """bits: (C, L) uint8 on any device -> {seq_id: (C, L-len+1) bool
    exact-match mask} on the same device.  A window matches iff the +-1
    correlation equals the sequence length (integer sums, exact in
    float32)."""
    x = 1.0 - 2.0 * bits.to(torch.float32)
    return {sid: _conv_valid_real(x, torch.from_numpy(k).to(bits.device))
            >= (n - 0.5) for sid, n, k in _seq_kernels()}


def first_hits(bits: np.ndarray, device=None) -> dict:
    """Host-facing: {seq_id: (C,) first match offset or -1}, correlated on
    `device` (the current CUDA device unless the caller asks for the
    CPU)."""
    bits = np.atleast_2d(np.asarray(bits, np.uint8))
    masks = train_seq_hits(torch.from_numpy(bits).to(resolve_device(device)))
    out = {}
    for sid, m in masks.items():
        m = m.cpu().numpy()
        out[sid] = np.where(m.any(axis=1), m.argmax(axis=1), -1)
    return out
