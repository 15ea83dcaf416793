"""The plain voice reference (tests/plain_voice.py, the benchmark's
tetra_bench/reference/voice.py byte for byte) against the port's batched
voice path: the speech decode of a superblock's slots and halves in one
trellis pass (voice/speech_batch.py), the TEA1 keystreams of many slots in
one call (crypto/tea_batch.py) and ACELP synthesis of many calls in one
call (voice/acelp.AcelpBank), with its float16 control."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tests import plain_voice as RV
from tetra_bench.air import cipher, speech
from tetra_tpu_torch.crypto import tea_batch
from tetra_tpu_torch.voice.acelp import AcelpBank, AcelpDecoder
from tetra_tpu_torch.voice.speech_batch import decode_speech

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the benchmark cell's limit on voice_pcm_err
with open(os.path.join(ROOT, "tetra_bench", "cells", "voice.json")) as _f:
    PCM_LIMIT = json.load(_f)["voice_pcm_err"]


def test_the_two_copies_are_byte_equal():
    with open(os.path.join(ROOT, "tests", "plain_voice.py"), "rb") as a, \
            open(os.path.join(ROOT, "tetra_bench", "reference", "voice.py"),
                 "rb") as b:
        assert a.read() == b.read()


def _noisy(bits: np.ndarray, rng, sigma: float) -> np.ndarray:
    """Soft values of bits (+1 ~ 0) with Gaussian noise, quantized to
    1/16 within +-2, as a soft-decision slicer gives them."""
    x = 1.0 - 2.0 * bits + rng.normal(0.0, sigma, bits.shape)
    return (np.clip(np.round(x * 16), -32, 32) / 16).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.45, 0.9])
def test_batched_speech_decode_equals_the_reference_per_slot(sigma):
    """Slots and halves with noisy soft bits, from mostly clean frames
    (sigma 0.45) to mostly bad ones (0.9): the batched decode's frames and
    bad-frame flags equal the reference's, one slot at a time, bit for
    bit."""
    rng = np.random.default_rng(41)
    frames = rng.integers(0, 2, (24, 2, 137)).astype(np.uint8)
    halves = rng.integers(0, 2, (10, 137)).astype(np.uint8)
    soft = _noisy(np.stack([speech.encode_slot(f) for f in frames]), rng,
                  sigma)
    hsoft = _noisy(np.stack([speech.encode_half_slot(h) for h in halves]),
                   rng, sigma)
    f, b, hf, hb = decode_speech(torch.from_numpy(soft),
                                 torch.from_numpy(hsoft))
    want = [RV.decode_slot(s) for s in soft]
    hwant = [RV.decode_half(s) for s in hsoft]
    assert np.array_equal(f.numpy(), np.stack([w[0] for w in want]))
    assert b.numpy().tolist() == [w[1] for w in want]
    assert np.array_equal(hf.numpy(), np.stack([w[0] for w in hwant]))
    assert hb.numpy().tolist() == [w[1] for w in hwant]
    n_bad = sum(w[1] for w in want + hwant)
    clean = sum(not w[1] and np.array_equal(w[0], fr)
                for w, fr in zip(want + hwant, list(frames) + list(halves)))
    if sigma < 0.5:
        assert clean > 0
    else:
        assert n_bad > 0


def test_tea1_batch_equals_the_reference_decryption():
    """A superblock's keystreams in one call against the reference's
    decryption of each slot: full slots and a half (frame 2 alone)."""
    rng = np.random.default_rng(42)
    keys = [bytes(rng.integers(0, 256, 10, dtype=np.uint8)) for _ in range(3)]
    ecks = [RV.cell_key(3600, 21, 5 + i, k) for i, k in enumerate(keys)]
    n = 40
    t = np.stack([rng.integers(1, 61, n), rng.integers(1, 18, n),
                  rng.integers(1, 5, n)], axis=1)
    key_of = rng.integers(0, 3, n)
    ivs = cipher.build_iv(t[:, 0], t[:, 1], t[:, 2], 42)
    ks = np.unpackbits(tea_batch.tea1_batch(
        ivs, key_of, np.stack([np.frombuffer(e, np.uint8) for e in ecks]),
        35, threads=3), axis=1)[:, :274].reshape(n, 2, 137)
    frames = rng.integers(0, 2, (n, 2, 137)).astype(np.uint8)
    for i in range(n):
        half = i % 5 == 0
        got = frames[i] ^ ks[i]
        if half:
            got[0] = frames[i, 0]
        want = RV.decrypt(frames[i], *t[i], 42, ecks[key_of[i]], half=half)
        assert np.array_equal(got, want), i


def test_acelp_bank_equals_one_decoder_a_call():
    """Items of many calls in one batch, in call order on worker threads:
    each call's PCM equals a decoder of its own fed its items in order;
    a half is 240 samples of silence then its frame; a withheld item is
    silence and leaves its call's decoder as it was."""
    rng = np.random.default_rng(43)
    n, n_calls = 600, 23
    calls = rng.integers(0, n_calls, n)
    frames = rng.integers(0, 2, (n, 2, 137)).astype(np.uint8)
    bfi = rng.random((n, 2)) < 0.05
    kind = rng.choice([0, 0, 0, 1, 2], n).astype(np.int8)
    bank = AcelpBank(threads=4)
    half_way = n // 2
    pcm = np.concatenate([bank.decode(calls[s], frames[s], bfi[s], kind[s])
                          for s in (slice(0, half_way), slice(half_way, n))])
    decs = {}
    for i in range(n):
        if kind[i] == 2:
            assert not pcm[i].any()
            continue
        d = decs.setdefault(int(calls[i]), AcelpDecoder())
        if kind[i] == 0:
            want = np.concatenate([d.decode_frame(frames[i, 0], bfi[i, 0]),
                                   d.decode_frame(frames[i, 1], bfi[i, 1])])
        else:
            want = np.concatenate([np.zeros(240, np.int16),
                                   d.decode_frame(frames[i, 1], bfi[i, 1])])
        assert np.array_equal(pcm[i], want), i
    assert len(bank) == len(decs)


def _codec_pcm(frames, bfi):
    """(B, T, 240) PCM of the codec: one AcelpDecoder a call."""
    return np.stack([np.stack([d.decode_frame(f, b) for f, b in zip(fc, bc)])
                     for d, fc, bc in zip(
                         [AcelpDecoder() for _ in frames], frames, bfi)])


def _reference_pcm(frames, bfi, dtype):
    B, T = frames.shape[:2]
    syn = RV.Synth(B, dtype)
    return np.stack([syn.frame(frames[:, t], bfi[:, t]) for t in range(T)],
                    axis=1)


def test_reference_synthesis_is_the_codecs_and_float16_fails():
    """Calls side by side over 60 frames of random bits (loud, resonant
    speech), some flagged bad: the reference in float32 gives the codec's
    PCM to the sample (it computes the codec's float32 operations in the
    codec's order, with the C library's cosf and expf), within
    voice_pcm_err's limit; the control, the same synthesis in float16,
    misses the limit many times over."""
    rng = np.random.default_rng(44)
    B, T = 12, 60
    frames = rng.integers(0, 2, (B, T, 137)).astype(np.uint8)
    bfi = rng.random((B, T)) < 0.04
    codec = _codec_pcm(frames, bfi).astype(np.int64)
    err = np.abs(_reference_pcm(frames, bfi, np.float32) - codec).max()
    assert err == 0 <= PCM_LIMIT
    with np.errstate(all="ignore"):
        ctl = np.abs(_reference_pcm(frames, bfi, np.float16) - codec).max()
    assert ctl > 16 * PCM_LIMIT


def test_synthesize_runs_calls_of_any_length_with_halves():
    """synthesize(): each call's slots in order, a half 240 samples of
    silence then its frame 2, equal to a decoder a call."""
    rng = np.random.default_rng(45)
    items, want = [], []
    for n in (3, 0, 7, 5):
        d, slots, out = AcelpDecoder(), [], []
        for k in range(n):
            f = rng.integers(0, 2, (2, 137)).astype(np.uint8)
            half = k % 3 == 2
            slots.append((f, np.zeros(2, bool), half))
            first = np.zeros(240, np.int16) if half else d.decode_frame(f[0])
            out.append(np.concatenate([first, d.decode_frame(f[1])]))
        items.append(slots)
        want.append(np.array(out, np.int16).reshape(n, 480))
    for got, w in zip(RV.synthesize(items), want):
        assert np.array_equal(got, w)
