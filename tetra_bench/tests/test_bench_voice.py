"""The air's voice, slot-stealing and TEA1 arms, the signalling checks
slot by slot, a cell's own module loaded from new files, and device time
by the program's ranges.

The arms are held bit-equal to the program's TX fixture
(tx.wideband.voice_cell_air); the existing cells' air is held to its
digest from before the arms existed; the blocks expected of each slot
are held to the fleet engine's own counters on voice air; and a voice
cell with TEA1 on cells 4-7 and steals of both kinds runs through
run_cell with a test-only cell module (voice_count_cell.py), correct.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, run_small

from tetra_bench import harness, tracing
from tetra_bench.air import cipher, speech
from tetra_bench.air import protocol as P
from tetra_bench.air.downlink import (Cell, Crypto, Encoder, Voice,
                                      _keystreams, downlink)
from tetra_bench.air.synth import build_air, cells_of, cipher_arm, voice_of
from tetra_bench.reference import truth

CELLS = dict(count=8, mcc=262, mnc0=100, cc0=1)
ENCRYPTED = [4, 5, 6, 7]
CRYPTO = {"algorithm": "TEA1", "cells": ENCRYPTED, "cck_id": 3}
# the fixture's steal plan: cell i steals frame 3 + i % 5 of timeslot 2
# (first half), 10 + i % 6 (both halves), and 16 (both halves on even
# cells, the first half on odd ones)
VOICE = {"timeslots": [2], "steals": [
    {"kind": "first", "timeslot": 2, "frames": [3, 4, 5, 6, 7]},
    {"kind": "both", "timeslot": 2, "frames": [10, 11, 12, 13, 14, 15]},
    {"kind": "both", "timeslot": 2, "frames": [16, None]},
    {"kind": "first", "timeslot": 2, "frames": [None, 16]}]}
C, T50, WB_K = 16, 6400, 8
SEED = 2 ** 33 + 19


# -- the arms against the program's fixture -----------------------------------

def test_voice_steal_and_tea1_arms_match_the_program_fixture(tmp_path,
                                                            monkeypatch):
    from tetra_tpu_torch.crypto.state import KeyStore
    from tetra_tpu_torch.tx import wideband as W
    seed, seconds = 7, 2.5
    keys = str(tmp_path / "keys.txt")
    with open(keys, "w") as f:
        f.write(W.cell_keystore(range(8), seed=3))
    streams = {}
    monkeypatch.setattr(W, "_multiplex",
                        lambda s, ch, sd: streams.setdefault("s", s))
    _, precs = W.voice_cell_air(8, seconds, keystore=keys,
                                encrypted=ENCRYPTED, seed=seed)
    key_of = {k.mnc - 100: k.key for k in KeyStore.load(keys).keys}
    n_slots = int(seconds / 0.014167) + 4
    kinds = set()
    for i in range(8):
        rng = np.random.default_rng(seed * 1000 + i)
        steals = {(3 + i % 5, 2): "first", (10 + i % 6, 2): "both",
                  (16, 2): "first" if i % 2 else "both"}
        voice = Voice(frozenset({2}), lambda rng=rng: rng.integers(
            0, 2, (2, 137)).astype(np.uint8), steals)
        # the fixture's first slot is timeslot 2 of frame 11, multiframe 2
        cell = Cell(262, 100 + i, 1 + i)
        crypto = Crypto(key_of[i], 3) if i in ENCRYPTED else None
        bits, recs = downlink(
            cell, n_slots, np.random.default_rng(seed * 1000 + 500 + i),
            mn0=2, first=41, voice=voice, crypto=crypto)
        # the one departure: on an encrypted cell the frame surviving a
        # first-half steal is enciphered (the fixture sends it clear), in
        # the second half block of its burst alone
        fixture = streams["s"][i].reshape(n_slots, P.BITS_PER_TS)
        ours = bits.reshape(n_slots, P.BITS_PER_TS)
        enc = Encoder(P.scramb_init(cell.mcc, cell.mnc, cell.cc))
        ks = None if crypto is None else _keystreams(cell, crypto, n_slots,
                                                     41, 2, None)
        differ = set()
        for p, rec in enumerate(recs):
            if "half_frame" in rec and crypto is not None:
                clear = enc.scramble(speech.encode_half_slot(
                    rec["half_frame"]))
                sent = enc.scramble(speech.encode_half_slot(
                    rec["half_frame"] ^ ks[p][speech.FRAME_BITS:]))
                # bits 282-497 the second half block, 498-499 its
                # phase-adjustment bits
                assert np.array_equal(ours[p][282:498], sent)
                assert np.array_equal(fixture[p][282:498], clear)
                assert np.array_equal(ours[p][:282], fixture[p][:282])
                assert np.array_equal(ours[p][500:], fixture[p][500:])
                differ.add(p)
            else:
                assert np.array_equal(ours[p], fixture[p]), (i, p)
        assert bool(differ) == (i in ENCRYPTED), i
        for p, (rec, pr) in enumerate(zip(recs, precs[i])):
            t1 = pr.type1
            kinds.add((pr.kind, i in ENCRYPTED))
            if pr.kind == "voice":
                assert set(rec) == {(P.T_BBK, 0), "frames"}
                assert np.array_equal(rec["frames"], t1["frames"])
                assert np.array_equal(rec[(P.T_BBK, 0)], t1["aach"])
                continue
            if pr.kind == "stch":
                assert np.array_equal(rec[(P.T_NDB, 1)], t1["stch1"])
                if rec["steal"] == "first":
                    assert np.array_equal(rec["half_frame"],
                                          t1["frames"][1])
                else:
                    assert np.array_equal(rec[(P.T_NDB, 2)], t1["stch2"])
                continue
            names = {(P.T_SB1, 1): "sb1", (P.T_SB2, 2): "sb2",
                     (P.T_BBK, 0): "aach", (P.T_NDB, 1): "ndb1",
                     (P.T_NDB, 2): "ndb2"}
            assert {names[k]: v.tolist() for k, v in rec.items()} == \
                {k: v.tolist() for k, v in t1.items() if k != "sdu"}, p
    assert {k for k, _ in kinds} == {"voice", "stch", "ndb", "sync"}


def test_tea1_keystream_iv_and_key_derivation_match_the_program():
    from tetra_tpu_torch.crypto import state, tea
    from tetra_tpu_torch.rx.tdma import TdmaTime
    rng = np.random.default_rng(11)
    for _ in range(3):
        key = bytes(rng.integers(0, 256, 10, dtype=np.uint8))
        ivs = rng.integers(0, 1 << 29, 16)
        got = cipher.tea1(ivs, key, 36)
        for iv, row in zip(ivs, got):
            assert bytes(row) == tea.tea1(int(iv), key, 36)
    for mn, fn, tn, hn in ((1, 1, 1, 42), (60, 18, 4, 0x7FFF), (9, 7, 2, 3)):
        assert int(cipher.build_iv(mn, fn, tn, hn)) == state.build_iv(
            TdmaTime(hn=hn, mn=mn, fn=fn, tn=tn), hn)
    assert cipher.tb5(3600, 21, 5, key) == state.tb5(3600, 21, 5, key)


def test_speech_coder_matches_the_program():
    from tetra_tpu_torch.voice import channel as vc
    rng = np.random.default_rng(12)
    for _ in range(8):
        f = rng.integers(0, 2, (2, 137)).astype(np.uint8)
        assert np.array_equal(speech.encode_slot(f),
                              vc.encode_slot(f.reshape(-1)))
        assert np.array_equal(speech.encode_half_slot(f[1]),
                              vc.encode_half_slot(f[1]))


def test_the_keystore_is_the_programs_text_format(tmp_path):
    from tetra_tpu_torch.crypto.state import CryptoState, KeyStore
    cells = cells_of(CELLS)
    arms, text = cipher_arm(CRYPTO, cells, SEED)
    path = str(tmp_path / "keys")
    with open(path, "w") as f:
        f.write(text)
    store = KeyStore.load(path)
    assert sorted(k.mnc - 100 for k in store.keys) == ENCRYPTED
    for k in store.keys:
        i = k.mnc - 100
        assert k.key == arms[i].key and k.key_num == 3
        cs = CryptoState(store=store)
        cs.cck_id = 3
        cs.update_network(262, k.mnc)
        assert cs.cck is not None and cs.network.ksg_type == 1
    assert cipher_arm(CRYPTO, cells, SEED)[1] == text
    assert cipher_arm(CRYPTO, cells, SEED + 1)[1] != text


# -- the existing cells' air --------------------------------------------------

# sha256 of each cell's air at seed 2**31 + 19, cut to 16 carriers, from the
# tree before the arms existed: (the bit streams, records, carriers and
# draws; with them the air's float planes)
AIR_DIGESTS = {
    "band256.full": (
        "dc2b5efb227e8117e54f6ccf9f8e604c5c304e08c0bb0d24ea31264128200333",
        "9f243a5c3282acb77f66bbf4b3dfb0a2e1fc9bc7a528c3938b45b4e02a165bda"),
    "band1024.host": (
        "dc2b5efb227e8117e54f6ccf9f8e604c5c304e08c0bb0d24ea31264128200333",
        "9f243a5c3282acb77f66bbf4b3dfb0a2e1fc9bc7a528c3938b45b4e02a165bda"),
    "band1024.sparse": (
        "10b4e85c8baa7c1e620a3fa28915c4ad0fe9050e51901391a03dad207fa83276",
        "57979378e35fd0379a495158664e4282d71d5ef406fbd5c9a1b18f2d05b1a552"),
}


def air_digest(root: str, workload: str, seed: int, carriers: int = 16,
               device="cpu") -> tuple[str, str]:
    """(digest of the air's exact data, digest with its float planes too)
    of a workload's air, its configuration cut to `carriers`."""
    _, _, config, traffic = harness.cell_spec(root, workload)
    config = json.loads(json.dumps(config))
    config["receiver"]["wideband"] = carriers
    air, occupied = harness.cell_air(config, traffic, seed, device, ext=4096)
    h = hashlib.sha256()
    for d in air.dibits:
        h.update(d.tobytes())
    for recs in air.records:
        for rec in recs:
            for k in sorted(rec):
                h.update(repr(k).encode())
                h.update(np.asarray(rec[k]).tobytes())
    for a in (air.cell_of, air.cfo_hz, occupied):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((air.period, air.fs, air.period_slots, air.start)).encode())
    exact = h.hexdigest()
    h.update(air.re.cpu().numpy().tobytes())
    h.update(air.im.cpu().numpy().tobytes())
    return exact, h.hexdigest()


@pytest.mark.parametrize("workload", sorted(AIR_DIGESTS))
def test_existing_cells_air_is_unchanged(workload):
    assert air_digest(REPO, workload, 2 ** 31 + 19) == AIR_DIGESTS[workload]


# -- slot by slot -------------------------------------------------------------

def voice_air(seed, period_multiframes=4, occupied=None):
    adv = T50 * C // 2
    return build_air(C, cells_of(CELLS),
                     np.ones(C, bool) if occupied is None else occupied,
                     period_multiframes, 25.0, 400.0, seed, "cpu",
                     ext=(WB_K + 2) * adv + 128 * C, voice=VOICE,
                     crypto=CRYPTO)


def test_expected_blocks_by_slot_kind():
    air = voice_air(SEED)
    sent = truth.SentBlocks(air.records)
    for i, recs in enumerate(air.records):
        for p, rec in enumerate(recs):
            want = (1 if "frames" in rec else 2 if "half_frame" in rec
                    else 3)
            assert sent.expected[i, p] == want
        kinds = [r.get("steal", "frames" in r) for r in recs]
        assert {"first", "both", True, False} <= set(kinds)
    # a chance pass is excused only where the air sent speech
    assert set(np.unique(sent.speech)) == {-1, truth.T_NDB, truth.T_SCH_F}
    voice = np.array([["frames" in r for r in recs]
                      for recs in air.records])
    assert np.array_equal(sent.speech[:, :, 0] == truth.T_SCH_F, voice)


def test_expected_blocks_match_the_engine_on_voice_air():
    """Each carrier's good blocks over staged superblocks equal the blocks
    its records expect of the slots it consumed, slot by slot."""
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    torch.set_num_threads(4)
    air = voice_air(SEED)
    rx = TetraReceiver(wideband=C, t50=T50, fleet=True, wb_k=WB_K,
                       device="cpu")
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    pos = air.start

    def staged(n):
        nonlocal pos
        for _ in range(n):
            o = pos % air.period
            rx.process_wideband_staged(
                air.re.as_strided((WB_K, wl), (adv, 1), o).contiguous(),
                air.im.as_strided((WB_K, wl), (adv, 1), o).contiguous())
            pos += WB_K * adv

    staged(5)
    before = [harness._chan_state(rx, c) for c in range(C)]
    staged(5)                              # across the 4.08 s wrap
    sent = truth.SentBlocks(air.records)
    for c in range(C):
        s0, ok0, *_, t0 = before[c]
        s1, ok1, *_ = harness._chan_state(rx, c)
        p0 = int(truth.slot_of(*t0, air.period_slots)) + 1
        assert s1 - s0 > 300
        assert ok1 - ok0 == truth.expected_blocks(
            sent, air.cell_of[c], p0, s1 - s0), c
        assert ok1 - ok0 < 3 * (s1 - s0)


def test_a_chance_pass_is_excused_on_speech_only():
    air = voice_air(SEED)
    sent = truth.SentBlocks(air.records)
    recs = air.records[0]
    p_voice = next(p for p, r in enumerate(recs) if "frames" in r)
    p_first = next(p for p, r in enumerate(recs) if "half_frame" in r)
    p_sig = next(p for p, r in enumerate(recs)
                 if (P.T_NDB, 2) in r and "steal" not in r)
    stamps = [(p // 72 + 1, (p % 72) // 4 + 1, p % 4 + 1)
              for p in (p_voice, p_first, p_sig, p_sig, p_first)]
    rows = {"chan": np.zeros(5, np.int64),
            "btype": np.array([truth.T_SCH_F, truth.T_NDB, truth.T_SCH_F,
                               truth.T_NDB, truth.T_NDB]),
            "bnum": np.array([0, 2, 0, 2, 2]),
            "mn": np.array([s[0] for s in stamps]),
            "fn": np.array([s[1] for s in stamps]),
            "tn": np.array([s[2] for s in stamps]),
            "ok": np.ones(5, bool),
            "type1": np.zeros((5, 34), np.uint8)}
    # a signalling slot's NDB 2 (an SDS) stamped onto the first steal
    sds = np.zeros(34 * 8, np.uint8)
    sds[:124] = recs[p_sig][(P.T_NDB, 2)]
    rows["type1"][4] = np.packbits(sds)
    wrong, good, bad, chance = truth.block_errors(rows, air.cell_of, sent,
                                                  air.period_slots)
    # the speech SCH/F and the first steal's speech half are excused; an
    # SCH/F and a wrong NDB 2 on a signalling slot are wrong, and so is a
    # block sent on a signalling slot but stamped where speech was sent
    assert (wrong, good, chance) == (3, 3, 2)
    assert bad.tolist() == [2, 3, 4]


# -- a cell's own module ------------------------------------------------------

def add_voice_cell(root: str, seconds_warmup: float = 4.0) -> str:
    """A 16-carrier voice cell with TEA1 on cells 4-7 and the test cell
    module, added to the copy at `root` by files alone; its name."""
    bench = os.path.join(root, "tetra_bench")
    with open(os.path.join(bench, "configs", "band256.json")) as f:
        cfg = json.load(f)
    cfg["receiver"]["wideband"] = C
    cfg["crypto"] = CRYPTO
    cfg["cell_module"] = "voice_count"
    with open(os.path.join(bench, "configs", "voice16.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "voice.json"), "w") as f:
        json.dump({"feed": "staged", "occupancy": 1.0,
                   "period_multiframes": 4, "warmup_s": seconds_warmup,
                   "voice": VOICE}, f)
    os.makedirs(os.path.join(bench, "cells"), exist_ok=True)
    shutil.copy(os.path.join(BENCH, "tests", "voice_count_cell.py"),
                os.path.join(bench, "cells", "voice_count.py"))
    with open(os.path.join(bench, "cells", "voice_count.json"), "w") as f:
        json.dump({"voice_calls_off": 0}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["workloads"].append(
        {"name": "voice16.voice", "config": "voice16", "traffic": "voice",
         "chips": 1, "why": "a CPU test's voice cell"})
    with open(path, "w") as f:
        json.dump(manifest, f)
    return "voice16.voice"


def _hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "tetra_bench")):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def test_voice_cell_with_its_module_is_correct(bench_copy):
    before = _hashes(bench_copy)
    name = add_voice_cell(bench_copy)
    mod = {}

    def spy(h):
        load = h.load_cell_module

        def load_and_keep(root, config):
            m, lim = load(root, config)
            mod["m"] = m
            return m, lim
        h.load_cell_module = load_and_keep

    result, checks = run_small(bench_copy, name, SEED, seconds=4.0,
                               plant=spy)
    got = {n: v for n, v, _ in checks}
    assert result["correct"], checks
    assert got["missed_blocks"] == got["wrong_blocks"] == 0
    assert got["display_errors"] == got["dibit_errors"] == 0
    assert got["voice_calls_off"] == 0
    assert list(got) == ["frontend_err", "dibit_errors", "wrong_blocks",
                         "missed_blocks", "display_errors", "voice_calls_off"]
    # fewer blocks than 3 a slot: the voice slots expect the AACH alone
    slots = result["attempted"] / 3
    assert result["failed"] == 0 and slots > 100
    calls = [c[0] for c in mod["m"].CALLS]
    assert calls == ["receiver_kwargs", "attach", "collect", "checks"]
    keys = mod["m"].CALLS[0][1]
    assert sorted(int(k[4]) - 100 for k in keys) == ENCRYPTED
    # the keystore's file is gone; no file the benchmark had changed
    after = _hashes(bench_copy)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("planted", [False, True])
def test_the_window_counts_each_chance_pass_on_speech(bench_copy, capfd,
                                                      planted):
    """The engine's good-CRC SCH/F rows (all on voice slots: the signalling
    air sends none) counted at its dispatch over the window equal the
    harness's surplus of good blocks over those expected; with a chance
    pass planted in each dispatch (carrier 0's first SCH/F row given a
    good CRC, its bits as decoded) the surplus counts every one, the
    captured superblocks hold some, and the run stays correct: each is
    excused, none missed or wrong."""
    import ctypes
    import importlib
    name = add_voice_cell(bench_copy)
    good = np.zeros(C, np.int64)
    snaps = []

    def plant(h):
        pr = importlib.import_module(h.__package__ + ".probes")
        real = pr._LibProxy.fleet_dispatch

        def dispatch(self, hnd, t1p, ok, meta, n, voice, half, actions,
                     times):
            if n:
                m = pr._view(meta, ctypes.c_int64,
                             n * pr.META_COLS).reshape(n, pr.META_COLS)
                o = pr._view(ok, ctypes.c_uint8, n)
                sch = np.nonzero(m[:, 1] == truth.T_SCH_F)[0]
                on0 = sch[m[sch, 0] == 0]
                if planted and len(on0):
                    o[on0[0]] = 1
                np.add.at(good, m[sch, 0], o[sch].astype(np.int64))
            return real(self, hnd, t1p, ok, meta, n, voice, half, actions,
                        times)
        pr._LibProxy.fleet_dispatch = dispatch
        state = h._chan_state

        def counted_state(rx, c):
            snaps.append(int(good[c]))
            return state(rx, c)
        h._chan_state = counted_state

    capfd.readouterr()
    result, checks = run_small(bench_copy, name, SEED + 3, seconds=4.0,
                               plant=plant)
    err = capfd.readouterr().err
    line = [ln for ln in err.splitlines()
            if ln.startswith("chance CRC passes on speech:")]
    assert len(line) == 1, err[-2000:]
    surplus, captured = (int(w) for w in line[0].split()
                         if w.isdigit())
    window = sum(snaps[C:2 * C]) - sum(snaps[:C])
    assert len(snaps) == 2 * C
    assert surplus == window
    assert result["correct"], checks
    got = {n: v for n, v, _ in checks}
    assert got["missed_blocks"] == got["wrong_blocks"] == 0
    if planted:
        assert window >= 1 and 1 <= captured <= window
    else:
        assert window == captured == 0


def test_a_configuration_without_a_module_runs_as_before(bench_copy,
                                                         monkeypatch):
    """No cell module: the receiver gets the configuration's arguments
    alone, nothing under cells/ is loaded, the checks are the five."""
    os.makedirs(os.path.join(bench_copy, "tetra_bench", "cells"))
    with open(os.path.join(bench_copy, "tetra_bench", "cells",
                           "voice_count.py"), "w") as f:
        f.write("raise RuntimeError('loaded')\n")
    from tetra_tpu_torch.rx import receiver
    made = []
    real = receiver.TetraReceiver

    def spy(**kw):
        made.append(kw)
        return real(**kw)
    monkeypatch.setattr(receiver, "TetraReceiver", spy)
    result, checks = run_small(bench_copy, "small.full", SEED, seconds=2.0)
    assert result["correct"], checks
    assert [n for n, _, _ in checks] == [
        "frontend_err", "dibit_errors", "wrong_blocks", "missed_blocks",
        "display_errors"]
    with open(os.path.join(bench_copy, "tetra_bench", "configs",
                           "small.json")) as f:
        cfg = json.load(f)
    assert made == [dict(cfg["receiver"], fleet=True,
                         device=torch.device("cpu"))]
    # 3 blocks a consumed slot on all-signalling air, as before
    assert result["attempted"] % 3 == 0


# -- device time by the program's ranges --------------------------------------

def _synthetic_trace():
    """A profiler trace: the window, a bench.fec range holding tetra.fec
    and its tetra.fec.wait, a bench.engine range; kernels launched under
    each; returns (events, expected program seconds)."""
    ev = []

    def rng(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": dur})

    def kernel(name, launch, ts, dur, corr):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": launch, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})
    rng("bench.window", 0, 1000)
    rng("bench.fec", 100, 400)
    rng("tetra.fec", 110, 380)
    rng("tetra.fec.wait", 400, 50)
    rng("bench.engine", 600, 300)
    rng("tetra.engine", 600, 300)
    rng("tetra.engine", 950, 20)
    kernel("trellis", 120, 130, 40, 1)
    kernel("trellis", 200, 210, 60, 2)
    kernel("gather", 410, 420, 30, 3)
    kernel("rm", 700, 705, 10, 4)
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "DtoH", "ts": 460,
               "dur": 20, "args": {"correlation": 5}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "copy", "ts": 450,
               "dur": 1, "args": {"correlation": 5}})
    return ev, {"tetra.fec": 150e-6, "tetra.fec.wait": 50e-6,
                "tetra.engine": 10e-6}


def test_program_ranges_get_the_device_time_of_their_launches():
    ev, want = _synthetic_trace()
    s = tracing.span_summary(ev)
    assert s["program_calls"] == {"tetra.fec": 1, "tetra.fec.wait": 1,
                                  "tetra.engine": 2}
    assert s["program_device_s"].keys() == want.keys()
    for k, v in want.items():
        assert s["program_device_s"][k] == pytest.approx(v)
    # the harness's keys read as without the program's ranges
    plain = tracing.span_summary([e for e in ev
                                  if not e["name"].startswith("tetra.")])
    for k in ("span_device_s", "span_calls", "idle_gaps"):
        assert s[k] == plain[k]
    assert s["span_device_s"]["bench.fec"] == pytest.approx(150e-6)
    d = tracing.device_summary(ev, 1e-3, top=2)
    assert d["device_ops"] == [["trellis", pytest.approx(100e-6)],
                               ["gather", pytest.approx(30e-6)]]
    assert d["device_op_s"] == pytest.approx(
        {"trellis": 100e-6, "gather": 30e-6, "rm": 10e-6, "DtoH": 20e-6})


# -- TEA1 across the air's wrap -----------------------------------------------

def test_a_receiver_following_the_sync_pdus_decrypts_across_the_wrap(
        tmp_path):
    """The program's per-channel MAC with the cell's keystore, fed an
    encrypted cell's bit stream over two wraps of a 4-multiframe period:
    every traffic slot, every first-half steal's surviving frame and every
    SDS after the cipher context is learnt (the SYSINFO's CCK-id and
    hyperframe arms) decrypts to the sent plaintext, the post-wrap
    multiframe included."""
    from tetra_tpu_torch.crypto.state import CryptoState, KeyStore
    from tetra_tpu_torch.rx.burst_sync import BurstSync
    from tetra_tpu_torch.rx.lower_mac import LowerMac
    from tetra_tpu_torch.rx.tdma import PhyState
    from tetra_tpu_torch.voice import channel as vc
    n_mf, i = 4, 5
    period = n_mf * P.SLOTS_PER_MULTIFRAME
    cells = cells_of(CELLS)
    arms, text = cipher_arm(CRYPTO, cells, SEED)
    bits, recs = downlink(cells[i], period,
                          np.random.default_rng([SEED, 100 + i]),
                          voice=voice_of(VOICE, i, SEED), crypto=arms[i],
                          wrap=n_mf)
    _, plain = downlink(cells[i], period,
                        np.random.default_rng([SEED, 100 + i]),
                        voice=voice_of(VOICE, i, SEED))
    keys = str(tmp_path / "keys")
    with open(keys, "w") as f:
        f.write(text)
    cs = CryptoState(store=KeyStore.load(keys))
    phy = PhyState()
    voice = []

    def cb(t, type4):
        frames, _ = vc.decode_slot(np.asarray(type4)[None], device="cpu")
        f = frames[0].copy()
        keyed = cs.decrypt_voice_bits(t, f)
        p = int(truth.slot_of(t.mn, t.fn, t.tn, period))
        voice.append((keyed, t.mn > n_mf,
                      np.array_equal(f.reshape(2, -1), recs[p]["frames"])))
    halves = []

    def half(t, type4):
        frame, _ = vc.decode_half_slot(np.asarray(type4)[None],
                                       device="cpu")
        ks = cs.keystream_bits(cs.cck, t, 2 * speech.FRAME_BITS) \
            if cs.cck else None
        if ks is not None:
            p = int(truth.slot_of(t.mn, t.fn, t.tn, period))
            halves.append(np.array_equal(
                frame[0] ^ ks[speech.FRAME_BITS:], recs[p]["half_frame"]))
    cb.half = half
    mac = LowerMac(phy=phy, voice_cb=cb, device="cpu")
    mac.upper.crypto_state = cs
    sync = BurstSync(phy=phy)
    start = 100 * P.BITS_PER_TS + 77             # inside multiframe 2
    stream = np.concatenate([bits] * 3)[start:]
    for a in range(0, len(stream), 36 * P.BITS_PER_TS):
        mac.process_bursts(sync.feed(stream[a:a + 36 * P.BITS_PER_TS]))
    keyed = [v for v in voice if v[0]]
    assert len(keyed) > 100 and all(v[2] for v in keyed)
    # the receiver stamps the post-wrap multiframe n_mf + 1 until its SYNC
    assert sum(v[1] for v in keyed) >= 2 * 13
    # a first-half steal's surviving frame: the program's keystream bits
    # 137-273 of the slot's time take it back to the plaintext sent
    assert len(halves) >= 4 and all(halves)
    # SDS: each decrypted TM-SDU equals the plaintext sent in its slot
    sds = [(e[1], e[2]) for e in mac.upper.events if e[0] == "tm_sdu"
           and len(e[2]) >= 77]
    n_sds = n_ok = 0
    for t, sdu in sds:
        rec = plain[int(truth.slot_of(t.mn, t.fn, t.tn, period))]
        if "steal" not in rec and (P.T_NDB, 2) in rec:
            n_sds += 1
            n_ok += np.array_equal(sdu[:77], rec[(P.T_NDB, 2)][43:120])
    assert n_ok == n_sds > 300
