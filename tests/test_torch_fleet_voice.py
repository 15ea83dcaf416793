"""The fleet receiver's voice monitor on the CPU at 16 carriers: the
benchmark's voice cell (monitor256.voice cut to 16 carriers and a
4-multiframe period: voice on timeslots 2-4, steals of both kinds on
timeslot 2, TEA1 on cells 4-7 with the keys held) through the harness and
its cell module, every call's frames against the sent plaintext and its
PCM against the plain reference, with the reference's float16 control;
the FEC's row selection on signalling and voice air, with the engine's
counts against the air's truth slot by slot; the monitor's hyperframe
across a multiframe wrap; the per-channel pipeline's stolen half on a
TEA1 cell; and the voice output's ring."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from tetra_tpu_torch import spans as S
from tetra_tpu_torch.rx.receiver import TetraReceiver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 16
SEED = 3 * 2 ** 31 + 11


def _bench_copy(root: str) -> str:
    """A copy of the benchmark with the voice cell and band256.full cut
    to C carriers and a 4-multiframe period (cells small.voice and
    small.full); returns its root."""
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "tetra_bench"),
                    os.path.join(root, "tetra_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = os.path.join(root, "tetra_bench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for cfg_name, traffic, cell in (("monitor256", "voice", "small.voice"),
                                    ("band256", "full", "small.full")):
        with open(os.path.join(bench, "configs", cfg_name + ".json")) as f:
            cfg = json.load(f)
        cfg["receiver"]["wideband"] = C
        with open(os.path.join(bench, "configs", f"small_{traffic}.json"),
                  "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(bench, "traffic", traffic + ".json")) as f:
            tr = json.load(f)
        tr["period_multiframes"] = 4
        with open(os.path.join(bench, "traffic", f"small_{traffic}.json"),
                  "w") as f:
            json.dump(tr, f)
        manifest["workloads"].append(
            {"name": cell, "config": f"small_{traffic}",
             "traffic": f"small_{traffic}", "chips": 1, "why": "a test's"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


def _bench_modules(root: str | None):
    """Forget the loaded tetra_bench modules; with root, import the copy's
    first."""
    for name in [m for m in sys.modules if m.split(".")[0] == "tetra_bench"]:
        del sys.modules[name]
    if root is not None:
        sys.path.insert(0, root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark copy; the engine and the voice monitor on one thread
    and torch on two, beside the suite's other workers."""
    root = _bench_copy(str(tmp_path_factory.mktemp("bench") / "checkout"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TETRA_FLEET_THREADS", "1")
        yield root
    torch.set_num_threads(threads)


def _run(root: str, cell: str, seconds: float, dtype=None):
    """run_cell of the copy's cell on the CPU; dtype: the precision the
    reference's ACELP synthesis runs in (None: its own, float32)."""
    _bench_modules(root)
    try:
        from tetra_bench import harness
        from tetra_bench.reference import voice as RV
        if dtype is not None:
            plain = RV.synthesize
            RV.synthesize = lambda items, dt=None: plain(items, dtype)
        return harness.run_cell(root, cell, SEED, seconds, False,
                                time.perf_counter(), device="cpu")
    finally:
        sys.path.remove(root)
        _bench_modules(None)


@pytest.mark.parametrize("synth", ["float32", "float16"])
def test_voice_cell_frames_and_pcm(bench, synth):
    """The voice cell at 16 carriers: every voice slot and surviving half
    of every call delivered once, its frames the sent plaintext (TEA1
    cells decrypted), no frame flagged bad, and the PCM the reference's
    synthesis to the sample (voice_pcm_err 0, within its limit), with
    every other check 0.  The control (the reference's synthesis in
    float16) fails voice_pcm_err alone, many times over its limit."""
    with np.errstate(all="ignore"):
        result, checks = _run(bench, "small.voice", 2.0,
                              None if synth == "float32" else np.float16)
    got = {n: (v, lim) for n, v, lim in checks}
    for n in ("dibit_errors", "wrong_blocks", "missed_blocks",
              "display_errors", "voice_slots_missed", "voice_frames_wrong"):
        assert got[n][0] == 0, (n, got[n])
    assert got["frontend_err"][0] <= got["frontend_err"][1]
    err, limit = got["voice_pcm_err"]
    if synth == "float32":
        assert err == 0 <= limit
        assert result["correct"]
    else:
        assert err > 16 * limit
        assert not result["correct"]


def _feed(root: str, cell: str, warm: int, superblocks: int,
          voice: bool = False):
    """A CPU receiver of the copy's cell fed `warm` superblocks, then
    `superblocks` more, its engine's speech-row selection recorded.
    Returns a dict: per carrier, the good and failed CRC counts over the
    last `superblocks`
    and the blocks the air's truth expects of the slots it consumed
    meanwhile, and the first-half steals among those slots (`counts`:
    (good, failed, expected, steals)); the fec.rows and
    voice.slots records a superblock; per superblock, the rows the
    engine emitted, decoded at feed time (BBK) and took as speech
    (`picked`); the voice blocks of the last `superblocks`; and the
    air."""
    _bench_modules(root)
    try:
        from tetra_bench import harness
        from tetra_bench.reference import truth
        _, _, config, traffic = harness.cell_spec(root, cell)
        keys = harness._write_keystore(config, SEED) if voice else None
        rx = TetraReceiver(**config["receiver"], fleet=True, device="cpu",
                           voice=voice, keystore=keys)
        wb = rx._wb
        air, _ = harness.cell_air(config, traffic, SEED, "cpu",
                                  ext=rx.wb_k * wb["advance"]
                                  + wb["wide_len"] + 32 * wb["hop"])
        feed = harness.Feed("staged", rx, air, None)
        eng, picked = rx.fleet, []
        real = eng._speech_rows

        def spy(meta, chans, blk_types):
            out = real(meta, chans, blk_types)
            local = (meta[:, 11] & 0x8000) != 0
            picked.append((len(meta), int(local.sum()), int(out.sum())))
            return out
        eng._speech_rows = spy
        S.clear()
        for _ in range(warm):
            feed.superblock()
        if voice:
            rx.take_voice()
        state = lambda: [(harness._chan_state(rx, c), rx.crc_counts(c)[1])
                         for c in range(C)]
        before, blocks = state(), []
        for _ in range(superblocks):
            feed.superblock()
            if voice:
                blocks += rx.take_voice()
        after = state()
        rec = S.records()
        if keys:
            os.remove(keys)
        sent = truth.SentBlocks(air.records)
        counts = []
        for ((s0, ok0, *_, t0), f0), ((s1, ok1, *_), f1), cell in zip(
                before, after, air.cell_of[:C]):
            p0 = int(truth.slot_of(*t0, air.period_slots)) + 1
            recs = air.records[int(cell)]
            halves = sum("half_frame" in recs[(p0 + k) % len(recs)]
                         for k in range(s1 - s0))
            counts.append((ok1 - ok0, f1 - f0, truth.expected_blocks(
                sent, int(cell), p0, s1 - s0), halves))
        return dict(counts=counts, fec_rows=rec["fec.rows"].tolist(),
                    voice_slots=rec["voice.slots"].tolist(), picked=picked,
                    blocks=blocks, air=air)
    finally:
        sys.path.remove(root)
        _bench_modules(None)


def test_signalling_air_rows_and_counts_unchanged(bench):
    """On signalling-only air (band256.full at 16 carriers) the engine
    takes no row as speech, so every row not decoded at feed time goes
    to the FEC, as before the voice monitor (a steady superblock's FEC
    rows are exactly those); and every carrier's counts
    are those the air's truth gives slot by slot: each block sent in the
    slots it consumed counted good, none failed."""
    got = _feed(bench, "small.full", 1, 2)
    assert len(got["picked"]) == 3
    for n, local, speech in got["picked"]:
        assert speech == 0 and n > local
    # a steady superblock (the first two re-decode under adopted codes)
    n, local, _ = got["picked"][-1]
    assert got["fec_rows"][-1] == n - local
    assert sum(got["voice_slots"]) == 0
    for c, (good, failed, expected, steals) in enumerate(got["counts"]):
        assert expected > 0 and (good, failed, steals) == (expected, 0, 0), c


@pytest.fixture(scope="module")
def voice_air(bench):
    """Four superblocks of the voice cell's air through a voice receiver,
    the last two measured (every carrier timed by then)."""
    return _feed(bench, "small.voice", 2, 2, voice=True)


def test_voice_air_speech_rows_skip_the_fec(voice_air):
    """On voice air the full-slot speech rows leave the FEC pass (about
    half of a steady superblock's rows at three voice timeslots), and the
    counts stay as missed_blocks expects them: every carrier's good CRCs
    are the blocks the air's truth gives its slots (a voice slot counts
    its AACH, a first-half steal its STCH), and the failed CRCs are the
    first-half steals' second halves, one each (decoded as a signalling
    half and counted, as before the voice monitor; a speech row's SCH/F
    is neither decoded nor counted)."""
    n, local, speech = voice_air["picked"][-1]
    assert voice_air["fec_rows"][-1] == n - local - speech
    assert speech > 0.4 * (n - local)
    assert sum(steals for *_, steals in voice_air["counts"]) > 0
    for c, (good, failed, expected, steals) in enumerate(
            voice_air["counts"]):
        assert expected > 0 and (good, failed) == (expected, steals), c


def test_voice_blocks_per_call(voice_air):
    """take_voice() gives one block a superblock; on the TEA1 cells (4-7)
    the frames are decrypted once the cipher state is known, on the clear
    cells passed through; halves carry their frame in frame 2 only; each
    delivered frame is the sent plaintext of its slot."""
    from tetra_tpu_torch.voice import monitor as M
    blocks, air = voice_air["blocks"], voice_air["air"]
    assert len(blocks) == 2 and sum(voice_air["voice_slots"][2:]) == sum(
        int((b.kind == M.FULL).sum()) for b in blocks)
    from tetra_bench.reference import truth
    P = air.period_slots
    seen = set()
    for b in blocks:
        for i in range(len(b)):
            cell = int(air.cell_of[b.carrier[i]])
            rec = air.records[cell][int(truth.slot_of(*b.time[i, 1:4], P))]
            assert b.crypt[i] == (M.DECRYPTED if cell >= 4 else M.CLEAR)
            assert not b.bfi[i].any()
            if b.kind[i] == M.HALF:
                assert not b.frames[i, 0].any()
                assert np.array_equal(b.frames[i, 1], rec["half_frame"])
            else:
                assert np.array_equal(b.frames[i], rec["frames"])
            seen.add((int(b.kind[i]), int(b.timeslot[i])))
    assert seen >= {(M.FULL, 2), (M.FULL, 3), (M.FULL, 4), (M.HALF, 2)}


def test_monitor_hyperframe_across_a_multiframe_wrap(tmp_path):
    """The voice monitor on one TEA1 carrier whose air crosses hyperframe
    boundaries inside a superblock: the hyperframe PDU (42) is latched in
    multiframe 59 and the rows after it in multiframes 60, 1 and 2, in
    that superblock and the next, lie in hyperframes 42 and 43; a PDU of
    hyperframe 44 latched in multiframe 1 leaves the row before it, in
    multiframe 60, in hyperframe 43.  Each row's frames, enciphered with
    its own slot's keystream, come out as the plaintext."""
    from types import SimpleNamespace
    from tetra_tpu_torch import params as P
    from tetra_tpu_torch.crypto.state import CryptoState, KeyStore
    from tetra_tpu_torch.rx import fec as rx_fec
    from tetra_tpu_torch.rx.tdma import TdmaTime
    from tetra_tpu_torch.tx.cell import build_sysinfo_pdu
    from tetra_tpu_torch.tx.wideband import cell_keystore
    from tetra_tpu_torch.voice import channel as vc
    from tetra_tpu_torch.voice import monitor as M
    keys = str(tmp_path / "keys.txt")
    with open(keys, "w") as f:
        f.write(cell_keystore([1]))
    mcc, mnc, cc, la, cn = 262, 101, 2, 21, 3600
    scr = P.scramb_get_init(mcc, mnc, cc)
    engine = SimpleNamespace(scramb=np.array([scr]), cell_mcc=np.array([mcc]),
                             cell_mnc=np.array([mnc]), cell_cc=np.array([cc]))
    cs = CryptoState(store=KeyStore.load(keys))
    cs.cc, cs.la, cs.cn, cs.cck_id = cc, la, cn, 3
    cs.update_network(mcc, mnc)
    rng = np.random.default_rng(11)
    mon = M.VoiceMonitor(1, torch.device("cpu"), keystore=keys)

    def sysinfo(**kw):
        bits = build_sysinfo_pdu(cn, 3, la=la, bs_service_details=0, **kw)
        return np.packbits(np.r_[bits, np.zeros(34 * 8 - len(bits),
                                                np.uint8)])

    def superblock(rows):
        """rows: ("sb1" | ("hn", n) | ("cck", n) | hn of a voice row,
        (mn, fn, tn)); returns the plaintext frames of the voice rows."""
        n = len(rows)
        meta = np.zeros((n, 12), np.int64)
        times = np.zeros((n, 5), np.int64)
        t5p = np.zeros((n, 54), np.uint8)
        type1p = np.zeros((n, 34), np.uint8)
        ok = np.zeros(n, bool)
        voice, plain = [], []
        for i, (what, (mn, fn, tn)) in enumerate(rows):
            times[i, 1:4] = mn, fn, tn
            meta[i, 3] = i
            if what == "sb1":
                meta[i, 1], ok[i] = P.TPSAP_T_SB1, True
            elif isinstance(what, tuple):
                meta[i, 1], ok[i] = P.TPSAP_T_SB2, True
                type1p[i] = sysinfo(hyperframe=what[1]) if what[0] == "hn" \
                    else sysinfo(hyperframe=0, cck_id=what[1])
            else:
                meta[i, 1] = P.TPSAP_T_SCH_F
                cs.hn = what
                ks = cs.keystream_bits(cs.cck, TdmaTime(mn=mn, fn=fn, tn=tn),
                                       274)
                frames = rng.integers(0, 2, 274).astype(np.uint8)
                t5 = vc.encode_slot(frames ^ ks) ^ rx_fec.keystream(scr, 432)
                t5p[i] = np.packbits(t5)
                voice.append(i)
                plain.append(frames.reshape(2, 137))
        mon.process(engine, np.array(voice), np.zeros(len(voice), np.int8),
                    t5p, meta, times, type1p, ok)
        return plain

    want = superblock([("sb1", (59, 18, 1)), (("cck", 3), (59, 18, 2)),
                       (("hn", 42), (59, 18, 3)), (42, (60, 1, 2)),
                       (42, (60, 17, 3)), (43, (1, 1, 2)), (43, (1, 4, 4))])
    want += superblock([(43, (2, 3, 2)), (43, (2, 10, 3))])
    want += superblock([(43, (60, 16, 2)), (("hn", 44), (1, 18, 3)),
                        (44, (2, 1, 2))])
    got = mon.take()
    assert [len(b) for b in got] == [4, 2, 2]
    b = [x for x in got]
    crypt = np.concatenate([x.crypt for x in b])
    frames = np.concatenate([x.frames for x in b])
    assert (crypt == M.DECRYPTED).all()
    assert not np.concatenate([x.bfi for x in b]).any()
    assert np.array_equal(frames, np.stack(want))


def test_voice_ring_keeps_the_newest_superblocks():
    """An undrained ring holds RING_BLOCKS superblocks, drops the oldest
    and counts it."""
    from tetra_tpu_torch.voice import monitor as M
    mon = M.VoiceMonitor(2, torch.device("cpu"))
    meta = np.zeros((0, 12), np.int64)
    for k in range(M.RING_BLOCKS + 3):
        mon.process(None, np.zeros(0, np.int64), np.zeros(0, np.int8),
                    np.zeros((0, 54), np.uint8), meta,
                    np.zeros((0, 5), np.int64), np.zeros((0, 34), np.uint8),
                    np.zeros(0, bool))
    assert mon.dropped == 3 and len(mon.take()) == M.RING_BLOCKS
    assert mon.take() == []


def test_fleet_keystore_needs_voice():
    with pytest.raises(ValueError, match="voice=True"):
        TetraReceiver(wideband=16, fleet=True, device="cpu",
                      keystore="keys.txt")


def test_pipeline_half_decrypts_its_frame(tmp_path):
    """The per-channel pipeline on a TEA1 cell: the surviving frame of a
    first-half steal, sent enciphered with the slot's keystream bits
    137-273, is decrypted before synthesis (240 samples of silence, then
    the plaintext frame's PCM); without a key it is synthesised as sent."""
    from tetra_tpu_torch.crypto.state import CryptoState, KeyStore
    from tetra_tpu_torch.rx.tdma import TdmaTime
    from tetra_tpu_torch.tx.wideband import cell_keystore
    from tetra_tpu_torch.voice import channel as vc
    from tetra_tpu_torch.voice.acelp import AcelpDecoder
    from tetra_tpu_torch.voice.pipeline import VoicePipeline
    keys = str(tmp_path / "keys.txt")
    with open(keys, "w") as f:
        f.write(cell_keystore([1]))
    cs = CryptoState(store=KeyStore.load(keys))
    cs.cc, cs.la, cs.cn, cs.hn, cs.cck_id = 2, 21, 3600, 42, 3
    cs.update_network(262, 101)
    assert cs.cck is not None
    rng = np.random.default_rng(7)
    for keyed in (True, False):
        vp = VoicePipeline(device="cpu", crypto_state=cs if keyed else None)
        dec = AcelpDecoder()
        want = []
        for k in range(3):
            t = TdmaTime(hn=0, mn=3, fn=4 + k, tn=2)
            frame = rng.integers(0, 2, 137).astype(np.uint8)
            ks = cs.keystream_bits(cs.cck, t, 274)[137:]
            vp.half(t, vc.encode_half_slot(frame ^ ks))
            want += [np.zeros(240, np.int16),
                     dec.decode_frame(frame if keyed else frame ^ ks)]
        assert vp.slots_decoded == 3 and vp.bad_frames == 0
        assert np.array_equal(vp.take_audio(), np.concatenate(want))
