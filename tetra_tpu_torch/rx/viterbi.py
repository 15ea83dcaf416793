"""Batched soft-decision Viterbi decoder for the TETRA K=5 mother codes
(port of tetra_tpu/rx/viterbi.py: _trellis_tables, _acs_tables, _viterbi
and viterbi_decode).

The 16-state trellis runs over a batch of blocks, one add-compare-select
step per trellis time as a handful of torch ops (the reference's XLA scan;
it was never a Pallas kernel).  Branch metrics are small integers (soft
bits in {-1, 0, +1} and the mixed-decode pad amplitude against +-1 signs),
so every metric is exact in float32 and decisions are bit-identical to the
reference whatever the summation order.

Soft-bit convention: +1 ~ transmitted bit 0, -1 ~ bit 1, 0 ~ punctured.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P

N_STATES = 16  # K=5 -> 2^(K-1)
_NEG = -1e9


def _trellis_tables(polys: np.ndarray):
    """Expected-sign table E[s, b, n] = 1-2*g_n and predecessor tables.
    State bit i holds the input bit delayed by i+1; s --b--> ((s<<1)|b)&15."""
    n_out = polys.shape[0]
    E = np.empty((N_STATES, 2, n_out), np.float32)
    for s in range(N_STATES):
        delayed = [(s >> i) & 1 for i in range(4)]
        for b in range(2):
            window = np.array([b] + delayed, np.int64)
            g = (polys.astype(np.int64) @ window) % 2
            E[s, b] = 1.0 - 2.0 * g
    ns = np.arange(N_STATES)
    prev0 = ns >> 1
    prev1 = (ns >> 1) + 8
    b_of = ns & 1
    return (E, prev0.astype(np.int32), prev1.astype(np.int32),
            b_of.astype(np.int32))


_CCH_TABLES = _trellis_tables(P.CONV_CCH_POLYS)
_TCH_TABLES = _trellis_tables(P.CONV_TCH_POLYS)


@lru_cache(maxsize=4)
def _acs_tables(use_tch: bool):
    """(n, 16) expected-sign operands E0t, E1t: the branch metric of the
    transition into ns from prev0[ns] (resp. prev1[ns]) is y @ E0t[:, ns]."""
    E, prev0, prev1, b_of = (_TCH_TABLES if use_tch else _CCH_TABLES)
    E0 = E[prev0, b_of]
    E1 = E[prev1, b_of]
    return np.ascontiguousarray(E0.T), np.ascontiguousarray(E1.T)


def _viterbi(soft: torch.Tensor, use_tch: bool, truncate: bool
             ) -> torch.Tensor:
    """soft (B, T, n) float32 -> decoded bits (B, T) uint8."""
    E0t, E1t = (torch.from_numpy(t).to(soft.device)
                for t in _acs_tables(use_tch))
    B, T, _ = soft.shape
    dev = soft.device
    bitw = (1 << torch.arange(N_STATES, dtype=torch.int32, device=dev))[None]
    # all branch metrics at once: (B, T, 16) per predecessor half
    bm0 = soft @ E0t
    bm1 = soft @ E1t
    metrics = torch.full((B, N_STATES), _NEG, dtype=torch.float32,
                         device=dev)
    metrics[:, 0] = 0.0
    decisions = torch.empty((T, B), dtype=torch.int32, device=dev)
    for t in range(T):
        cand0 = metrics[:, :8].repeat_interleave(2, dim=1) + bm0[:, t]
        cand1 = metrics[:, 8:].repeat_interleave(2, dim=1) + bm1[:, t]
        take1 = cand1 > cand0
        new = torch.where(take1, cand1, cand0)
        metrics = new - new.max(dim=1, keepdim=True).values
        # decisions bit-packed per row: 16 states -> one int32 word
        decisions[t] = torch.where(take1, bitw, 0).sum(dim=1,
                                                       dtype=torch.int32)
    if truncate:
        state = metrics.argmax(dim=1).to(torch.int32)
    else:
        state = torch.zeros(B, dtype=torch.int32, device=dev)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        took1 = ((decisions[t] >> state) & 1) == 1
        state = torch.where(took1, (state >> 1) + 8, state >> 1)
    return bits


def viterbi_decode(soft: torch.Tensor, code: str = "cch",
                   term: str = "zero") -> torch.Tensor:
    """Decode batched soft mother-code symbols.

    soft: (B, T, N) float32 (0 = punctured), N=4 for the data (CCH) code,
    N=3 for the speech (TCH) code.  Returns (B, T) uint8 bits.  term="zero":
    zero-terminated blocks (traceback from state 0); "truncate": traceback
    from the best-metric end state."""
    use_tch = code == "tch"
    n_out = 3 if use_tch else 4
    if soft.shape[-1] != n_out:
        raise ValueError(f"{code} soft symbols need last dim {n_out}")
    return _viterbi(soft.to(torch.float32), use_tch, term == "truncate")
