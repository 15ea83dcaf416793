"""Seeded batches for the ACELP synthesis tests (the card's kernel and its
host build against voice/acelp.AcelpBank), and random codec tables.  No
jax: the card tests import it too."""

from __future__ import annotations

import numpy as np

FRAME_BITS = 137


def batches(seed: int, n_calls: int = 70, n_batches: int = 3,
            key_span: int = 1024, most: int = 12):
    """n_batches successive batches (calls, frames, bfi, kind) of n_calls
    calls with distinct keys below key_span: each call 0 to `most` items
    a batch (its lengths unequal), the calls' items interleaved in a
    seeded order, each call's in time order; seeded frames, bad-frame
    flags on ~8% of frames, ~10% surviving halves, ~10% withheld.  Call 0
    opens with withheld items, call 1 is withheld through the first batch
    (its decoder is made in the second), and call 2 has no items in the
    second batch."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(key_span, n_calls, replace=False).astype(np.int64)
    out = []
    for b in range(n_batches):
        lengths = rng.integers(0, most + 1, n_calls)
        lengths[:2] = np.maximum(lengths[:2], 4)
        if b == 1:
            lengths[2] = 0
        owner = np.repeat(np.arange(n_calls), lengths)
        owner = owner[rng.permutation(len(owner))]
        n = len(owner)
        kind = rng.choice([0, 1, 2], n, p=[0.8, 0.1, 0.1]).astype(np.int8)
        pos = np.zeros(n, np.int64)
        for c in range(n_calls):
            at = np.nonzero(owner == c)[0]
            pos[at] = np.arange(len(at))
        if b == 0:
            kind[(owner == 0) & (pos < 3)] = 2
            kind[owner == 1] = 2
        frames = rng.integers(0, 2, (n, 2, FRAME_BITS)).astype(np.uint8)
        bfi = rng.random((n, 2)) < 0.08
        frames[kind == 1, 0] = 0
        bfi[kind == 1, 0] = False
        out.append((keys[owner], frames, bfi, kind))
    return out


def random_tables(seed: int) -> dict:
    """Codec tables for voice/acelp.load_codec_tables (np.savez them): LSF
    codevectors around the speech means, gains over the codec's range, and
    fewer rows than the fields address (the index is taken modulo)."""
    rng = np.random.default_rng(seed)
    means = np.array([0.24, 0.47, 0.81, 1.12, 1.44, 1.78, 2.09, 2.40,
                      2.68, 2.94], np.float32)
    return dict(
        lsf_cb1=(means[:3] + rng.normal(0, 0.1, (200, 3))).astype(np.float32),
        lsf_cb2=(means[3:6] + rng.normal(0, 0.1, (512, 3))).astype(
            np.float32),
        lsf_cb3=(means[6:] + rng.normal(0, 0.1, (300, 4))).astype(
            np.float32),
        gain_cb=np.stack([rng.uniform(0, 1.3, 50),
                          np.exp(rng.uniform(1.0, 8.0, 50))], 1).astype(
                              np.float32),
        lsf_pred=np.float32(0.3))
