"""The production streaming topology on the port, end to end on the CPU
(the counterpart of tests/test_soak_stream.py): the port's IqStream plays
a capture file back, a feeder cuts it into staged superblock windows, a
pipelined fleet receiver (link_profile="pcie") with a voice sink decodes
them, a checkpoint is taken mid-stream and restored into a second
receiver, which must then track the first exactly.  The reference's
pipelined receiver, fed the same windows, calls its voice sink with the
same frames after every superblock: one superblock late in both."""

import numpy as np
import jax.numpy as jnp
import torch

from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.runtime.iq_stream import IqStream
from tetra_tpu_torch.tx import cell
from tetra_tpu_torch.tx.wideband import synthesize_wideband
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

N, KW = 8, 2


def _build_stream(tmp_path, slots=220):
    """8 carriers of two cells, the first with voice on timeslot 2."""
    rng = np.random.default_rng(33)
    framegen = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
    streams = []
    for i in range(2):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=100 + i, cc=1 + i), slots,
            start=TdmaTime(mn=2, fn=14, tn=1),
            voice_slots={2: framegen} if i == 0 else None)
        streams.append(bits)
    L = min(len(s) for s in streams)
    bitmat = np.stack([streams[c % 2][:L] for c in range(N)])
    wide = synthesize_wideband(bitmat, N, cfo_hz=120.0, snr_db=25.0, seed=3)
    f = tmp_path / "soak.cf32"
    np.asarray(wide, np.complex64).tofile(f)
    return str(f)


class _StagedFeeder:
    """Drains an IqStream into process_wideband_staged superblocks: window
    j of superblock s covers wide samples [(s*KW + j)*advance, ... +
    wide_len)."""

    def __init__(self, stream: IqStream, wide_len: int, advance: int):
        self.stream, self.wide_len, self.advance = stream, wide_len, advance
        self.buf = np.zeros(0, np.complex64)
        self.need = (KW - 1) * advance + wide_len

    def next_superblock(self):
        while len(self.buf) < self.need:
            blk = self.stream.read(1 << 16, timeout_ms=500)
            if len(blk) == 0:
                return None
            self.buf = np.concatenate([self.buf, blk])
        wins = np.stack([self.buf[j * self.advance:
                                  j * self.advance + self.wide_len]
                         for j in range(KW)])
        self.buf = self.buf[KW * self.advance:]
        return (np.ascontiguousarray(wins.real, np.float32),
                np.ascontiguousarray(wins.imag, np.float32))


class _VoiceSink:
    half = None

    def __init__(self):
        self.frames = []

    def __call__(self, t, type4):
        self.frames.append((str(t), np.asarray(type4).tobytes()))


def test_streaming_soak_ring_staged_fleet_voice_checkpoint(tmp_path):
    path = _build_stream(tmp_path)
    sink, ref_sink = _VoiceSink(), _VoiceSink()
    rx1 = TetraReceiver(wideband=N, fleet=True, wb_k=KW, link_profile="pcie",
                        voice_cb=sink, device="cpu")
    ref = JaxReceiver(wideband=N, fleet=True, events=False, wb_k=KW,
                      wb_pipeline=True, voice_cb=ref_sink)
    assert rx1.wb_pipeline
    stream = IqStream(capacity=1 << 22)
    stream.feed_file(path)
    feeder = _StagedFeeder(stream, rx1._wb["wide_len"], rx1._wb["advance"])
    supers = []
    while (sb := feeder.next_superblock()) is not None:
        supers.append(sb)
    assert stream.overruns == 0 and stream.eof
    stream.stop()
    assert len(supers) >= 8, len(supers)
    # bounded memory: less than one superblock of residue
    assert len(feeder.buf) < feeder.need

    def feed(rx, sb):
        if isinstance(rx, JaxReceiver):
            rx.process_wideband_staged(*(jnp.asarray(a) for a in sb))
        else:
            rx.process_wideband_staged(*(torch.from_numpy(a) for a in sb))

    mid = len(supers) // 2
    heard = []
    for sb in supers[:mid]:
        feed(rx1, sb)
        feed(ref, sb)
        heard.append((len(sink.frames), len(ref_sink.frames)))
    rx1.flush_wideband()
    ref.flush_wideband()
    assert any(rx1.locked(c) for c in range(N))

    # mid-stream checkpoint -> a fresh receiver without voice (voice does
    # not change the decode state)
    ckpt = str(tmp_path / "soak.npz")
    rx1.save_state(ckpt)
    rx2 = TetraReceiver(wideband=N, fleet=True, wb_k=KW, link_profile="pcie",
                        device="cpu")
    rx2.load_state(ckpt)
    for c in range(N):
        assert rx2.locked(c) == rx1.locked(c), c
        assert rx2.crc_counts(c) == rx1.crc_counts(c), c

    losses = [rx1.fleet.lock_losses(c) for c in range(N)]
    for sb in supers[mid:]:
        for rx in (rx1, rx2, ref):
            feed(rx, sb)
        heard.append((len(sink.frames), len(ref_sink.frames)))
    for rx in (rx1, rx2, ref):
        rx.flush_wideband()

    for c in range(N):
        assert rx1.locked(c) and rx2.locked(c), c
        assert rx2.crc_counts(c) == rx1.crc_counts(c), c
        assert rx2.display(c).as_dict() == rx1.display(c).as_dict(), c
        assert rx2.fleet.lock_losses(c) == rx1.fleet.lock_losses(c), c
        # no lock lost after warm-up
        assert rx1.fleet.lock_losses(c) == losses[c], c
        oks, fails = rx1.crc_counts(c)
        assert oks > 50 and oks > 10 * max(fails, 1), (c, oks, fails)
        assert rx1.crc_counts(c) == ref.crc_counts(c), c
    assert rx2.fleet.state_bytes() == rx1.fleet.state_bytes()
    # voice through the deferred dispatch: the reference's frames, after
    # every superblock, and none before the first superblock is decoded
    assert all(a == b for a, b in heard), heard
    assert heard[0] == (0, 0)
    assert len(sink.frames) > 20 and sink.frames == ref_sink.frames
