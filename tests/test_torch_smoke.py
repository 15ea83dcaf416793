"""chip_smoke.py's measurement helpers on the CPU: the K4 and K3 library
yardsticks compute K4's and K3's functions, and the bounds follow from the
main path's shapes (K1 ~0.94 GFLOP and operation-bound, K2 ~16.9 MB and
byte-bound, K4 ~19.8 MB against a fold plus an FFT, K3's resample alone
~22.6 MB and byte-bound)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS  # noqa: E402
from tetra_tpu_torch.ops import chan_kernel as CK  # noqa: E402
from tetra_tpu_torch.parallel import channelizer as CH  # noqa: E402


@pytest.mark.parametrize("label", sorted(CS.K4_LIBRARY))
@pytest.mark.parametrize("n_ch, t50", [(16, 100), (64, 75)])
def test_k4_library_yardstick_matches_plain(n_ch, t50, label):
    rng = np.random.default_rng(n_ch)
    rows = t50 + 2 * CH.TAPS_PER_BRANCH - 1
    z = [torch.from_numpy(rng.standard_normal((rows, n_ch // 2)).astype(
        np.float32)) for _ in range(2)]
    lib = CS.K4_LIBRARY[label](z[0], z[1], n_ch)
    ref = CK.fold_dft_plain(z[0], z[1], n_ch)
    rms = float(torch.sqrt((ref[0] ** 2 + ref[1] ** 2).mean()))
    for a, b in zip(lib, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= CS.TOL_FRONT_REL * rms


@pytest.mark.parametrize("label", sorted(CS.K4_LIBRARY))
@pytest.mark.parametrize("n_ch, t50", [(16, 100), (64, 75)])
def test_k3_library_yardstick_matches_plain(n_ch, t50, label):
    """K3's yardstick (a K4 yardstick, then the resample einsum) computes
    K3's function, carried history included."""
    rng = np.random.default_rng(n_ch + 1)
    rows = t50 + 2 * CH.TAPS_PER_BRANCH - 1
    pad = CH.RS_TAPS_PER_PHASE - 1
    z = [torch.from_numpy(rng.standard_normal((rows, n_ch // 2)).astype(
        np.float32)) for _ in range(2)]
    h = [torch.from_numpy(rng.standard_normal((pad, n_ch)).astype(
        np.float32)) for _ in range(2)]
    t36 = t50 * 18 // 25
    lib = CS.k3_library(label, *z, *h, n_ch, t36)
    ref = CK.fold_dft_resample_plain(*z, *h, n_ch, t36)
    rms = float(torch.sqrt((ref[0] ** 2 + ref[1] ** 2).mean()))
    for a, b in zip(lib, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= CS.TOL_FRONT_REL * rms


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "resample"])
def test_bounds_at_main_path_shapes(name):
    C, T, n_s = CS.C_DEMOD, CS.T_DEMOD, 2 * CH.TAPS_PER_BRANCH
    rows = CS.T50 + n_s - 1
    S = 2432
    w = {"K1": lambda: CS.k1_work(T, C, 32),
         "K2": lambda: CS.k2_work(T, C, S, emit_syms=False),
         "K3": lambda: CS.k3_work(rows, CS.N_CH, n_s, CS.T50 * 18 // 25),
         "K4": lambda: CS.k4_work(rows, CS.N_CH, n_s),
         "resample": lambda: CS.resample_work(CS.T50, CS.N_CH,
                                              CS.T50 * 18 // 25)}[name]()
    assert w["bound_ms"] == pytest.approx(
        max(w["bytes"] / CS.HBM_BYTES_PER_S, w["ops"] / CS.FP32_OPS_PER_S)
        * 1e3)
    if name == "K1":
        assert w["bound_by"] == "operations"
        assert 0.9e9 < w["ops"] < 1.0e9 and 18e6 < w["bytes"] < 20e6
    if name == "K2":
        assert w["bound_by"] == "bytes"
        assert 16.5e6 < w["bytes"] < 17.5e6
    if name == "K4":
        # a fold (256 x 48 x 4) and a length-256 FFT (5 x 256 x 8) per
        # frame, 6400 frames; z in and the frames out, ~19.8 MB
        assert w["bound_by"] == "bytes"
        assert 0.37e9 < w["ops"] < 0.39e9 and 19e6 < w["bytes"] < 20.5e6
    if name == "K3":
        # K4's work plus the resample's 4608 x 256 x 96 ops
        assert w["bound_by"] == "operations"
        assert 0.49e9 < w["ops"] < 0.51e9 and 15.5e6 < w["bytes"] < 17e6
    if name == "resample":
        # y (6400 x 256) and the 23-row history in, the 4608 x 256 rows and
        # the next history out, re and im, and the (18, 24) taps and 18
        # offsets; 2 x 24 FMAs per output
        C, t36, pad = CS.N_CH, CS.T50 * 18 // 25, CH.RS_TAPS_PER_PHASE - 1
        assert w["bytes"] == 4 * (2 * CS.T50 * C + 2 * t36 * C
                                  + 4 * pad * C + 18 * 24 + 18)
        assert w["ops"] == t36 * C * 96
        assert w["bound_by"] == "bytes"
        assert 22.5e6 < w["bytes"] < 22.7e6


def test_voice_spies_replay_the_pipelines_audio():
    """slice_voice's spies: RecordingPipeline's SpyDecoder records each
    codec call under its TDMA time, and replay_audio reproduces the
    pipeline's audio from the record (full slots, a stolen half)."""
    from tetra_tpu_torch.rx.tdma import TdmaTime
    from tetra_tpu_torch.voice import channel
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 2, (3, 2, 137)).astype(np.uint8)
    vp = CS.RecordingPipeline(decoder=CS.SpyDecoder(), device="cpu")
    for fn, f in enumerate(frames[:2], start=1):
        vp(TdmaTime(mn=2, fn=fn, tn=2), channel.encode_slot(f.reshape(-1)))
    vp.half(TdmaTime(mn=2, fn=3, tn=2), channel.encode_half_slot(frames[2][1]))
    calls = vp.decoder.calls
    assert [(k, kind, b) for k, kind, _, b in calls] == [
        ((2, 1, 2), "slot", False), ((2, 2, 2), "slot", False),
        ((2, 3, 2), "frame", False)]
    np.testing.assert_array_equal(calls[1][2], frames[1])
    np.testing.assert_array_equal(calls[2][2], frames[2][1])
    audio = vp.take_audio()
    assert len(audio) == 3 * 480
    np.testing.assert_array_equal(audio, CS.replay_audio(calls))


def test_voice_truth_keeps_the_voice_bearing_slots():
    """voice_truth: voice slots give both frames, first-half steals their
    second frame, both-halves steals and signalling nothing."""
    from tetra_tpu_torch.rx.tdma import TdmaTime
    from tetra_tpu_torch.tx.cell import CellConfig, downlink_bits
    rng = np.random.default_rng(2)
    _, recs = downlink_bits(
        CellConfig(), 80, start=TdmaTime(mn=1, fn=1, tn=1),
        voice_slots={2: lambda: rng.integers(0, 2, (2, 137)).astype(
            np.uint8)},
        stolen_slots={(3, 2): "first", (5, 2): "both"})
    truth = CS.voice_truth(recs, 0, len(recs))
    assert truth[(1, 3, 2)][0] == "frame" and truth[(1, 2, 2)][0] == "slot"
    assert (1, 5, 2) not in truth and (1, 2, 3) not in truth
    voice = [r for r in recs if r.kind == "voice"]
    assert len(truth) == len(voice) + sum(
        r.kind == "stch" and "frames" in r.type1 for r in recs)
    np.testing.assert_array_equal(truth[(1, 3, 2)][1], next(
        r.type1["frames"][1] for r in recs
        if (r.time.mn, r.time.fn, r.time.tn) == (1, 3, 2)))
    assert len(CS.voice_truth(recs, 10, 20)) < len(truth)
