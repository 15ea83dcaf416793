"""The port's fleet receiver end to end on the CPU against tetra_tpu's:
wideband IQ -> decoded PDUs on 8 channels carrying 2 cells, the
narrowband fleet path, and fleet checkpoints restored across packages.

The reference runs its XLA twins on the CPU while the port runs its
kernels' plain versions, which round differently (the twin's channel-major
Costas ramp and arctan2 dist vs the kernel semantics the port follows).
A symbol at a decision boundary could therefore flip and change a CRC
tally; the bound below allows 2 blocks per channel.  Locks, the decoded
display state and the cells they show must be identical."""

import os

import numpy as np
import pytest
import torch

from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import (heterogeneous_fleet_iq,
                                         synthesize_wideband)
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

N = 8
CRC_BOUND = 2


@pytest.fixture(scope="module")
def wide():
    streams = []
    for i in range(2):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=100 + i, cc=1 + i), 120,
            start=TdmaTime(mn=2, fn=14, tn=1))
        streams.append(bits)
    L = min(len(s) for s in streams)
    bitmat = np.stack([streams[c % 2][:L] for c in range(N)])
    return synthesize_wideband(bitmat, N, cfo_hz=120.0, snr_db=25.0, seed=3)


def _span(rx, wide, start=0, stop=None):
    """Feed whole 4-cycle superblocks of the stream, in 120k-sample chunks
    (window slices start..stop of the whole-superblock span)."""
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    M = ((len(wide) - (wl - adv)) // adv) // 4 * 4
    data = wide[:(M - 1) * adv + wl][start:stop]
    for i in range(0, len(data), 120000):
        rx.process_wideband(data[i:i + 120000])
    rx.flush_wideband()
    return rx


def _assert_same_decode(a, b, bound=CRC_BOUND):
    for c in range(N):
        assert a.locked(c) == b.locked(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
        (oa, fa), (ob, fb) = a.crc_counts(c), b.crc_counts(c)
        assert abs(oa - ob) + abs(fa - fb) <= bound, (c, (oa, fa), (ob, fb))


def test_wideband_fleet_matches_jax(wide):
    ref = _span(JaxReceiver(wideband=N, fleet=True, events=False, wb_k=2),
                wide)
    got = _span(TetraReceiver(wideband=N, fleet=True, wb_k=2, device="cpu"),
                wide)
    _assert_same_decode(got, ref)
    for c in range(N):
        assert got.locked(c), c
        assert got.display(c).mnc == 100 + c % 2, c
        assert got.crc_counts(c)[0] > 10 * got.crc_counts(c)[1], c
        # the lean superblock keeps no symbols, in both packages
        assert len(got.constellation(c)[0]) == len(ref.constellation(c)[0]) \
            == 0
        assert got.quality_ok(c) == ref.quality_ok(c), c
    np.testing.assert_allclose(got.sym_quality, ref.sym_quality, atol=2e-3)


def test_wideband_cs16_feed_matches_cf32(wide):
    """Interleaved int16 IQ (converted on the device) decodes like the
    float feed of the same quantized samples."""
    scale = 0.5 / np.abs(wide).max()
    q = np.round(wide * scale * 32767)
    cs16 = np.stack([q.real, q.imag], axis=1).reshape(-1).astype(np.int16)
    cf32 = (q / 32768.0).astype(np.complex64)
    a = _span(TetraReceiver(wideband=N, fleet=True, wb_k=2, device="cpu"),
              cf32)
    b = TetraReceiver(wideband=N, fleet=True, wb_k=2, device="cpu")
    adv, wl = b._wb["advance"], b._wb["wide_len"]
    M = ((len(wide) - (wl - adv)) // adv) // 4 * 4
    b.process_wideband(cs16[:2 * ((M - 1) * adv + wl)])
    _assert_same_decode(a, b, bound=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_checkpoint_restores_across_packages(wide, tmp_path, writer):
    """A checkpoint written mid-stream by one package restores in the
    other: the restored receiver then continues exactly as the writer's
    own continuation (same package) or within the bound (other package)."""
    make_port = lambda: TetraReceiver(wideband=N, fleet=True, wb_k=2,
                                      device="cpu")
    make_jax = lambda: JaxReceiver(wideband=N, fleet=True, events=False,
                                   wb_k=2)
    first, other = (make_port, make_jax) if writer == "port" \
        else (make_jax, make_port)
    a = first()
    adv = a._wb["advance"]
    cut = 8 * adv + 12345                       # mid-window, mid-buffer
    _span(a, wide, 0, cut)
    path = os.path.join(tmp_path, "ckpt.npz")
    a.save_state(path)
    same, cross = first(), other()
    same.load_state(path)
    cross.load_state(path)
    for rx in (a, same, cross):
        _span(rx, wide, cut)
    for c in range(N):
        assert same.crc_counts(c) == a.crc_counts(c), c
        assert same.display(c).as_dict() == a.display(c).as_dict(), c
    _assert_same_decode(cross, a)
    assert all(cross.locked(c) for c in range(N))


def test_narrowband_fleet_matches_jax():
    xr, xi = heterogeneous_fleet_iq(9, 4, 4608, seed=11)
    iq = (xr + 1j * xi).astype(np.complex64)
    ref = JaxReceiver(channels=4, fleet=True, events=False)
    got = TetraReceiver(channels=4, fleet=True, device="cpu")
    for b in range(iq.shape[0]):
        ref.process(iq[b])
        got.process(iq[b])
    for c in range(4):
        assert got.locked(c) == ref.locked(c), c
        assert got.display(c).as_dict() == ref.display(c).as_dict(), c
        (oa, fa), (ob, fb) = got.crc_counts(c), ref.crc_counts(c)
        assert abs(oa - ob) + abs(fa - fb) <= CRC_BOUND, c
        # the last block's symbols: as many valid ones in both packages
        (gr, gi), (rr, ri) = got.constellation(c, n=100), ref.constellation(
            c, n=100)
        assert len(gr) == len(gi) == len(rr) == 100, c
        assert got.quality_ok(c) == ref.quality_ok(c), c
    assert sum(got.crc_counts(c)[0] for c in range(4)) > 0


@pytest.mark.parametrize("kw,state,fleet", [
    (dict(mode="ff"), "FfDemodState", False),
    (dict(fleet=True, mode="exact"), "DemodState", True),
    (dict(keystore="keys.txt"), "FastDemodState", False),
    (dict(mac_workers=2), "FastDemodState", False),
])
def test_ported_modes_construct(kw, state, fleet):
    """mode="ff" and mode="exact" (per-channel and fleet) construct with
    their chain's state, as the reference's do; keystore= without
    mac_workers is accepted and unused, as in the reference; mac_workers=2
    starts the MAC pool's two workers in place of the per-channel MACs,
    as the reference's does."""
    rx = TetraReceiver(channels=2, device="cpu", **kw)
    ref = JaxReceiver(channels=2, **kw)
    try:
        assert type(rx.state).__name__ == type(ref.state).__name__ == state
        assert (rx.fleet is not None) == fleet
        assert rx.state.agc_gain.device.type == "cpu"
        assert (rx.pool is not None) == (ref.pool is not None) == bool(
            kw.get("mac_workers"))
        assert len(rx.mac) == len(ref.mac)
        if rx.pool is not None:
            assert rx.pool.device.type == "cpu" and rx.pool.workers == 2
            assert rx.display(1).as_dict() == ref.display(1).as_dict()
            assert rx.crc_counts(1) == ref.crc_counts(1) == (0, 0)
            with pytest.raises(NotImplementedError, match="pool"):
                rx.save_state("unused.npz")
    finally:
        for r in (rx, ref):
            if r.pool is not None:
                r.pool.close()


@pytest.mark.parametrize("kw,match", [
    (dict(wideband=8, mode="ff"), "fast chain only"),
    (dict(mode="fastest"), "mode="),
    (dict(fleet=True, keystore="keys.txt"), "keystore"),
    (dict(fleet=True, mac_workers=2), "mac_workers"),
    (dict(mac_workers=2, voice_cb=print), "voice=True"),
])
def test_invalid_mode_combinations_raise(kw, match):
    """The reference asserts these (wideband fusion runs the fast chain;
    fleet mode takes no keystore and no MAC pool; the pool takes voice=True,
    not a voice_cb); the port raises ValueError, and also for a mode it
    does not know."""
    with pytest.raises(ValueError, match=match):
        TetraReceiver(channels=2, device="cpu", **kw)


def test_reference_call_forms():
    """The constructor calls of the reference's CLI (apps/tetra_rx.py: the
    default per-channel receiver and --fleet with --link-profile), of its
    bench_e2e (events=False; its wb_pipeline is link_profile="pcie" here)
    and of its README (TetraReceiver(channels=16)) run on the port."""
    cb = lambda time, type4: None
    rx = TetraReceiver(16, voice_cb=cb, mode="fast", events=False,
                       wideband=0, device="cpu")
    assert rx.fleet is None and not rx.device_acquire
    assert all(m.voice_cb is cb and not m.upper.events_enabled
               for m in rx.mac)
    rx = TetraReceiver(64, voice_cb=cb, mode="fast", events=True,
                       wideband=64, device="cpu")
    assert rx.device_acquire and rx.channels == 64
    assert rx.mac[0].upper.events_enabled
    for profile in ("tunnel", "pcie"):
        rx = TetraReceiver(8, voice_cb=None, mode="fast", events=False,
                           wideband=8, fleet=True, wb_k=2,
                           link_profile=profile, device="cpu")
        assert rx.fleet is not None and rx.link_profile == profile
    for profile in ("tunnel", "pcie"):
        rx = TetraReceiver(wideband=8, t50=1600, fleet=True, events=False,
                           wb_k=2, link_profile=profile, device="cpu")
        assert rx.wb_pipeline == (profile == "pcie")
    # events=True is ignored in fleet mode, as the reference's fleet
    # implies events=False
    TetraReceiver(wideband=8, fleet=True, events=True, device="cpu")
    assert TetraReceiver(channels=16, device="cpu").channels == 16
    with pytest.raises(ValueError, match="link_profile"):
        TetraReceiver(channels=2, link_profile="wifi", device="cpu")


def test_voice_true_constructs_as_in_the_reference():
    """voice=True without mac_workers constructs, as the JAX receiver's
    does (it selects worker-side pipelines in the MAC pool only); voice
    decodes through a VoicePipeline on each channel's voice_cb."""
    from tetra_tpu_torch.voice.pipeline import VoicePipeline
    JaxReceiver(channels=2, voice=True)
    rx = TetraReceiver(channels=2, voice=True, device="cpu")
    assert rx.fleet is None and len(rx.mac) == 2
    assert all(m.voice_cb is None for m in rx.mac)
    rx.mac[1].voice_cb = vp = VoicePipeline(device="cpu")
    assert rx.mac[1].voice_cb is vp and vp.device.type == "cpu"
    rx = TetraReceiver(wideband=8, t50=1600, voice=True, events=False,
                       device="cpu")
    assert rx.channels == 8


def test_device_is_required():
    """With no device= the receiver runs on the current CUDA device; on a
    machine without CUDA it raises rather than run on the CPU unasked."""
    if torch.cuda.is_available():
        rx = TetraReceiver(channels=2, fleet=True)
        assert rx.device == torch.device("cuda", torch.cuda.current_device())
        assert rx.state.agc_gain.device == rx.device
        return
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TetraReceiver(channels=2, fleet=True)
