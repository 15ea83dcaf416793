"""Batched soft-decision Viterbi decoders (port of tetra_tpu/rx/viterbi.py):
viterbi_decode for the TETRA K=5 mother codes (_trellis_tables,
_acs_tables, _viterbi) and viterbi_decode_generic for any non-recursive
(n, K <= 8) code with zero, truncated or tail-biting termination.

The 16-state trellis runs over a batch of blocks: on a CUDA tensor as one
kernel launch (ops/fec_trellis, csrc/fec_trellis.cu), elsewhere in its
plain twin _viterbi, one add-compare-select step per trellis time as a
handful of torch ops (the reference's XLA scan; it was never a Pallas
kernel).  Branch metrics are small integers (soft bits in {-1, 0, +1} and
the mixed-decode pad amplitude against +-1 signs), so every metric is
exact in float32 and decisions are bit-identical to the reference
whatever the summation order.

Soft-bit convention: +1 ~ transmitted bit 0, -1 ~ bit 1, 0 ~ punctured.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from .. import spans as S
from ..ops import fec_trellis

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
    from the best-metric end state.  A CUDA tensor takes the trellis
    kernel (T <= 288), its rows counted as fec.trellis_rows."""
    use_tch = code == "tch"
    n_out = 3 if use_tch else 4
    if soft.shape[-1] != n_out:
        raise ValueError(f"{code} soft symbols need last dim {n_out}")
    soft = soft.to(torch.float32)
    truncate = term == "truncate"
    if soft.device.type != "cuda":
        return _viterbi(soft, use_tch, truncate)
    S.count("fec.trellis_rows", soft.shape[0])
    return fec_trellis.trellis(soft.contiguous(), truncate)


# ---------------------------------------------------------------------------
# Generic engine: any non-recursive (n, K <= 8) code, with zero-terminated,
# truncated or tail-biting blocks (port of tetra_tpu/rx/viterbi.py's
# _generic_tables, _viterbi_generic and viterbi_decode_generic; the
# capability of osmo_conv.c:484-774).  Same batched layout as the
# specialized decoder above: one ACS step per trellis time as torch ops on
# the input's device.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _generic_tables(polys: tuple[tuple[int, ...], ...]):
    """Trellis tables for polys[(n, K)] with taps over [x_t, x_{t-1}, ...]:
    (E, prev0, prev1, b_of, S), E[s, b, n] = +-1 expected soft sign, the
    predecessor tables for next state ns = ((s << 1) | b) mod S
    (viterbi_cch.c:36-60 / gen_state_info in osmo_conv.c)."""
    pm = np.asarray(polys, np.int64)
    n_out, K = pm.shape
    S = 1 << (K - 1)
    E = np.empty((S, 2, n_out), np.float32)
    for s in range(S):
        delayed = [(s >> i) & 1 for i in range(K - 1)]
        for b in range(2):
            window = np.array([b] + delayed, np.int64)
            E[s, b] = 1.0 - 2.0 * ((pm @ window) % 2)
    ns = np.arange(S)
    return (E, (ns >> 1).astype(np.int32),
            ((ns >> 1) + S // 2).astype(np.int32),
            (ns & 1).astype(np.int32), S)


def _viterbi_generic(soft: torch.Tensor, polys: tuple, term: str
                     ) -> torch.Tensor:
    """soft (B, T, n) float32 -> decoded bits (B, T) uint8."""
    E, prev0, prev1, b_of, S = _generic_tables(polys)
    dev = soft.device
    B, T, n = soft.shape
    half = S // 2
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    p0, p1 = to(prev0.astype(np.int64)), to(prev1.astype(np.int64))
    # branch metric of the transition into ns from prev_k[ns]:
    # y @ E[prev_k[ns], b_of[ns]], for every step at once: (B, T, S)
    bm0 = soft @ to(E[prev0, b_of].T)
    bm1 = soft @ to(E[prev1, b_of].T)

    def forward(metrics, decisions):
        for t in range(T):
            cand0 = metrics[:, p0] + bm0[:, t]
            cand1 = metrics[:, p1] + bm1[:, t]
            take1 = cand1 > cand0
            new = torch.where(take1, cand1, cand0)
            metrics = new - new.max(dim=1, keepdim=True).values
            if decisions is not None:
                decisions[t] = take1
        return metrics

    def trace(state, decisions, bits=None):
        """Trace (B, k) states back through every step; the bits of column
        0 into `bits` when given.  Returns the start states."""
        for t in range(T - 1, -1, -1):
            if bits is not None:
                bits[:, t] = (state[:, 0] & 1).to(torch.uint8)
            took1 = torch.gather(decisions[t], 1, state)
            state = torch.where(took1, (state >> 1) + half, state >> 1)
        return state

    decisions = torch.empty((T, B, S), dtype=torch.bool, device=dev)
    if term == "tailbite":
        # osmo_conv tail-biting (conv_decode, osmo_conv.c:745-764): uniform
        # start metrics, two forward passes (wrap-around), decisions from
        # the second pass
        mid = forward(torch.zeros((B, S), dtype=torch.float32, device=dev),
                      None)
        final = forward(mid, decisions)
    else:
        init = torch.full((B, S), _NEG, dtype=torch.float32, device=dev)
        init[:, 0] = 0.0
        final = forward(init, decisions)

    if term == "zero":
        start = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    elif term == "truncate":
        start = final.argmax(dim=1, keepdim=True)
    else:
        # tail-biting state selection (traceback, osmo_conv.c:572-599):
        # among states whose T-step traceback returns to themselves
        # (circular consistency), the best end metric; if none is
        # consistent, the best end metric overall.  All S candidate
        # tracebacks run together.
        all_states = torch.arange(S, device=dev).expand(B, S).contiguous()
        consistent = trace(all_states, decisions) == all_states
        score = torch.where(consistent, final, final - 1e9)
        score = torch.where(consistent.any(dim=1, keepdim=True), score,
                            final)
        start = score.argmax(dim=1, keepdim=True)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    trace(start, decisions, bits)
    return bits


def viterbi_decode_generic(soft: torch.Tensor, polys, term: str = "zero"
                           ) -> torch.Tensor:
    """Decode any non-recursive convolutional code, batched, on soft's
    device.

    soft: (B, T, n) float32, +1 ~ bit 0 / -1 ~ bit 1 / 0 ~ punctured;
    polys: (n, K) generator tap matrix (rows g_i over [x_t .. x_{t-K+1}]),
    or a nested tuple of the same.  term: "zero" (encoder flushed to state
    0, tail steps included in soft), "truncate" (traceback from the best
    end state) or "tailbite" (wrap-around pass + the circularly consistent
    best state, CONV_TERM_TAIL_BITING of osmo_conv.c).  Returns (B, T)
    uint8 bits."""
    if not isinstance(polys, tuple):
        polys = tuple(tuple(int(x) for x in row) for row in np.asarray(polys))
    if soft.shape[-1] != len(polys):
        raise ValueError(f"soft symbols have {soft.shape[-1]} outputs, the "
                         f"code {len(polys)}")
    if term not in ("zero", "truncate", "tailbite"):
        raise ValueError(f"term={term!r}: 'zero', 'truncate' or 'tailbite'")
    return _viterbi_generic(soft.to(torch.float32), polys, term)
