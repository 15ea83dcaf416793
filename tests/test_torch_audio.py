"""The port's block resampler (parallel/channelizer.resample) and audio
output (voice/audio_out.AudioOutput) against tetra_tpu's on the same seeded
inputs.  Floats: the maximum error within 1e-5 of the reference's RMS."""

import numpy as np
import pytest
import torch

from tetra_tpu.parallel import channelizer as JCH
from tetra_tpu.voice.audio_out import AudioOutput as JAudio
from tetra_tpu_torch.parallel import channelizer as TCH
from tetra_tpu_torch.voice.audio_out import AudioOutput as TAudio

TOL_REL = 1e-5


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    rms = float(np.sqrt(np.mean(np.abs(ref) ** 2)))
    assert rms > 0
    assert float(np.abs(got - ref).max()) <= TOL_REL * rms


@pytest.mark.parametrize("L,M", [(18, 25), (25, 18), (6, 1), (2, 1),
                                 (3, 2)])
def test_resample_matches_jax(L, M):
    rng = np.random.default_rng(L * 31 + M)
    iq = (rng.standard_normal((3, 1500))
          + 1j * rng.standard_normal((3, 1500))).astype(np.complex64)
    _close(TCH.resample(iq, L, M, device="cpu"), JCH.resample(iq, L, M))


def test_resample_named_rates_match_jax():
    rng = np.random.default_rng(4)
    iq = (rng.standard_normal((2, 2000))
          + 1j * rng.standard_normal((2, 2000))).astype(np.complex64)
    _close(TCH.resample_50_to_36(iq, device="cpu"),
           JCH.resample_50_to_36(iq))
    _close(TCH.resample_36_to_50(iq, device="cpu"),
           JCH.resample_36_to_50(iq))
    # a 1-D input is one channel, as in the reference
    _close(TCH.resample(iq[0], 18, 25, device="cpu"),
           JCH.resample(iq[0], 18, 25))


@pytest.mark.parametrize("stereo", [True, False])
def test_render_matches_jax(stereo):
    rng = np.random.default_rng(12)
    pcm = (np.sin(2 * np.pi * 440 / 8000 * np.arange(960)) * 8000
           + rng.normal(0, 500, 960)).astype(np.int16)
    got = TAudio(device="cpu").render(pcm, stereo=stereo)
    _close(got, JAudio().render(pcm, stereo=stereo))
    assert len(got) == (960 - 24) * 6 * (2 if stereo else 1)


def test_rate_change_and_silence_match_jax():
    """The runtime sample-rate change: lengths, silence padding and the
    stereo interleave track the new rate as the reference's do."""
    pcm = (np.sin(2 * np.pi * 300 / 8000 * np.arange(480)) * 9000).astype(
        np.int16)
    t, j = TAudio(out_rate=48_000, device="cpu"), JAudio(out_rate=48_000)
    for rate in (16_000, 44_100, 48_000):
        t.set_out_rate(rate)
        j.set_out_rate(rate)
        assert (t.L, t.M, t.out_rate) == (j.L, j.M, j.out_rate)
        y = t.render(pcm)
        _close(y, j.render(pcm))
        assert np.array_equal(y[0::2], y[1::2])
        np.testing.assert_array_equal(t.silence(480), j.silence(480))


def test_audio_entry_points_need_cuda_unless_asked_for_the_cpu():
    """With no device= the resampler and the audio output run on the
    current CUDA device; without CUDA they raise rather than fall back."""
    iq = np.ones((1, 64), np.complex64)
    if torch.cuda.is_available():
        assert TAudio().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TAudio()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TCH.resample(iq, 6, 1)
