"""The port's tracer (tetra_tpu_torch.spans) in the fleet receiver on the
CPU: one record a superblock, fed staged and fed host cf32 one advance a
call; spans nested inside their parents; the hunting counter against the
valid counts of the superblock's words; the ingest's copied and uploaded
bytes against the fed bytes; no trellis-kernel rows on the CPU; the
tetra.* ranges in a profiler trace, and no range made without a
profiler; the ring's fixed size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tetra_tpu_torch import spans as S
from tetra_tpu_torch.rx import demod_fast
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import cell_air, staged_windows

N, KW = 16, 2
N_SB = 4
# each span's parent (spans' module docstring); "superblock" has none when
# fed staged
PARENT = {"ingest.buffer": "ingest", "ingest.frame": "ingest",
          "ingest.upload": "ingest", "superblock": "ingest",
          "step": "superblock", "fetch": "superblock",
          "engine": "superblock", "engine.feed": "engine", "fec": "engine",
          "fec.wait": "fec", "engine.dispatch": "engine"}


def _receiver():
    return TetraReceiver(wideband=N, fleet=True, wb_k=KW, device="cpu")


@pytest.fixture(scope="module")
def air():
    """2.6 s of cell air on 16 carriers (every carrier a cell)."""
    return cell_air(N, 2.6, 8)


def _spy_words(rx):
    """Record, for each superblock handed to the engine, the channels
    unlocked when its feed begins and the valid symbols per channel summed
    from its words' count rows."""
    seen = []
    post = rx._post_demod_fused
    G = 2 * rx._wb["n_chunks"] + -(-rx._wb["n_chunks"] // 4)

    def spy(fused):
        words = fused[:-2].reshape(KW, G, N)[:, 2 * rx._wb["n_chunks"]:]
        valid = words.astype(np.uint32).view(np.uint8).reshape(
            KW, -1, N, 4).sum(axis=(0, 1, 3), dtype=np.int64)
        seen.append((rx.fleet.unlocked().copy(), valid))
        return post(fused)
    rx._post_demod_fused = spy
    return seen


def _host_calls(rx, wide, n_sb):
    """The stream one advance a call, up to the call that runs superblock
    n_sb."""
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    need = (KW - 1) * adv + wl
    calls = -(-(need + (n_sb - 1) * KW * adv) // adv)
    return [wide[i * adv:(i + 1) * adv] for i in range(calls)]


def _check_nesting(rec):
    for name, parent in PARENT.items():
        assert (rec[name] <= rec[parent]).all() or (
            parent == "ingest" and not rec["ingest"].any()), (name, parent)
    self_ns = rec["engine"] - rec["engine.feed"] - rec["fec"] \
        - rec["engine.dispatch"]
    assert (self_ns >= 0).all()
    assert (rec["end_ns"] >= rec["start_ns"]).all()
    assert (rec["end_ns"] - rec["start_ns"] >= rec["superblock"]).all()
    assert (rec["calls"][:, S.SPANS.index("superblock")] == 1).all()
    assert (rec["calls"][:, S.SPANS.index("engine")] == 1).all()


@pytest.mark.parametrize("feed", ["staged", "host"])
def test_one_record_a_superblock(air, feed):
    rx = _receiver()
    seen = _spy_words(rx)
    S.clear()
    if feed == "staged":
        for wr, wi in staged_windows(air, rx._wb["advance"],
                                     rx._wb["wide_len"], KW, "cpu",
                                     count=N_SB):
            rx.process_wideband_staged(wr, wi)
    else:
        for chunk in _host_calls(rx, air, N_SB):
            rx.process_wideband(chunk)
    rec = S.records()
    assert list(rec["seq"]) == list(range(N_SB))
    _check_nesting(rec)
    assert (rec["superblock"] > 0).all() and (rec["fec.rows"] > 0).all()
    assert (rec["calls"][:, S.SPANS.index("fec.wait")] >= 1).all()
    # the first superblocks hunt on every carrier
    bits = [2 * int(v[u].sum()) for u, v in seen]
    assert list(rec["hunt.bits"]) == bits and bits[0] > 0
    if feed == "staged":
        assert not rec["ingest"].any() and not rec["ingest.bytes_fed"].any()
    else:
        assert (rec["ingest.upload"] > 0).all()
        assert (rec["calls"][:, S.SPANS.index("ingest.frame")] == 1).all()


def test_trellis_rows_read_zero_on_a_cpu_engine(air):
    """fec.trellis_rows counts the rows the trellis kernel decodes: every
    record holds it, and a CPU engine, whose FEC takes the kernel's plain
    twin, reads 0 beside its fec.rows."""
    rx = _receiver()
    S.clear()
    for wr, wi in staged_windows(air, rx._wb["advance"], rx._wb["wide_len"],
                                 KW, "cpu", count=2):
        rx.process_wideband_staged(wr, wi)
    rec = S.records()
    assert len(rec) == 2 and "fec.trellis_rows" in rec.dtype.names
    assert (rec["fec.rows"] > 0).all() and not rec["fec.trellis_rows"].any()


def test_ingest_bytes_follow_the_buffer_policy(air):
    """Each fed byte is written once on the host (into the ring, or into
    its staging on the card) and once into the ring: ingest.bytes_copied
    and ingest.bytes_uploaded each equal ingest.bytes_fed, one write a
    call.  A feed the ingest must cast (complex128) adds the cast's bytes
    to the copies, and uploads each sample's complex64 once."""
    rx = _receiver()
    S.clear()
    calls = _host_calls(rx, air, N_SB)
    for chunk in calls:
        rx.process_wideband(chunk)
    rec = S.records()
    assert len(rec) == N_SB
    fed = 8 * sum(len(c) for c in calls)
    assert int(rec["ingest.bytes_fed"].sum()) == fed
    assert int(rec["ingest.bytes_copied"].sum()) == fed
    assert int(rec["ingest.bytes_uploaded"].sum()) == fed
    assert (rec["ingest.bytes_uploaded"] == rec["ingest.bytes_fed"]).all()
    assert (rec["calls"][:, S.SPANS.index("ingest.buffer")].sum()
            == rec["calls"][:, S.SPANS.index("ingest.upload")].sum()
            == len(calls))

    rx = _receiver()
    S.clear()
    for chunk in calls:
        rx.process_wideband(chunk.astype(np.complex128))
    rec = S.records()
    assert len(rec) == N_SB
    assert int(rec["ingest.bytes_fed"].sum()) == 2 * fed
    assert int(rec["ingest.bytes_copied"].sum()) == 2 * fed
    assert int(rec["ingest.bytes_uploaded"].sum()) == fed


def test_hunting_bits_on_noise_then_on_cells(air):
    """Noise air: every carrier stays unlocked and hunt.bits is every
    valid bit fed.  Cell air: hunt.bits falls to 0 once every carrier has
    found its bursts."""
    rx = _receiver()
    seen = _spy_words(rx)
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    n = 3 * KW * adv + wl
    rng = np.random.default_rng(11)
    noise = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
    S.clear()
    for wr, wi in staged_windows(noise, adv, wl, KW, "cpu"):
        rx.process_wideband_staged(wr, wi)
    rec = S.records()
    assert len(rec) == len(seen) == 3
    for (unlocked, valid), bits in zip(seen, rec["hunt.bits"]):
        assert unlocked.all()
        assert bits == 2 * int(valid.sum()) > 0
    # the most a superblock can hold: every symbol slot of every carrier
    slots = KW * demod_fast.n_chunks_for(rx._wb["t36"]) * demod_fast.K_SYM
    assert (rec["hunt.bits"] <= 2 * N * slots).all()

    rx = _receiver()
    seen = _spy_words(rx)
    S.clear()
    for wr, wi in staged_windows(air, adv, wl, KW, "cpu"):
        rx.process_wideband_staged(wr, wi)
    rec = S.records()
    hunting = [int(u.sum()) for u, _ in seen]
    assert hunting[0] == N and hunting[-1] == 0, hunting
    for h, bits in zip(hunting, rec["hunt.bits"]):
        assert (bits == 0) == (h == 0), (hunting, list(rec["hunt.bits"]))


def _ranges(tmp_path, prof) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith("tetra."):
            out.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))
    return out


def _inside(child, parents) -> bool:
    c0, c1 = child
    return any(a <= c0 and c1 <= b for a, b in parents)


def test_profiler_trace_holds_nested_ranges(air, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    rx = _receiver()
    sbs = staged_windows(air, rx._wb["advance"], rx._wb["wide_len"], KW,
                         "cpu", count=2)
    rx.process_wideband_staged(*sbs[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx.process_wideband_staged(*sbs[1])
    r = _ranges(tmp_path, prof)
    for name in ("superblock", "step", "frontend", "demod", "fetch",
                 "engine", "engine.feed", "fec", "fec.wait",
                 "engine.dispatch"):
        assert "tetra." + name in r, (name, sorted(r))
    assert len(r["tetra.frontend"]) == len(r["tetra.demod"]) == KW
    for child, parent in (("step", "superblock"), ("fetch", "superblock"),
                          ("engine", "superblock"), ("fec", "engine"),
                          ("fec.wait", "fec"), ("frontend", "step"),
                          ("demod", "step"), ("engine.feed", "engine")):
        for iv in r["tetra." + child]:
            assert _inside(iv, r["tetra." + parent]), (child, parent)


def test_no_range_without_a_profiler(air, monkeypatch):
    """Off the profiler the spans never call record_function; under it
    every span and range does."""
    from torch.profiler import ProfilerActivity, profile
    made = []
    real = torch.profiler.record_function

    def stand_in(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", stand_in)
    rx = _receiver()
    sbs = staged_windows(air, rx._wb["advance"], rx._wb["wide_len"], KW,
                         "cpu", count=2)
    rx.process_wideband_staged(*sbs[0])
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        rx.process_wideband_staged(*sbs[1])
    assert "tetra.superblock" in made and "tetra.fec.wait" in made
    assert made.count("tetra.demod") == KW


def test_ring_wraps_without_growing():
    S.clear()
    ring = S._ring
    nbytes = ring.nbytes
    extra = 37
    for i in range(S.RING_ROWS + extra):
        with S.span("superblock"):
            S.count("fec.rows", i)
    rec = S.records()
    assert S._ring is ring and ring.nbytes == nbytes
    assert len(rec) == S.RING_ROWS
    assert list(rec["seq"][[0, -1]]) == [extra, S.RING_ROWS + extra - 1]
    assert (np.diff(rec["seq"]) == 1).all()
    assert (rec["fec.rows"] == rec["seq"]).all()
    S.clear()
    assert len(S.records()) == 0


def test_spans_between_superblocks_go_to_the_next_record():
    """A call that only buffers, then one that runs a superblock: both in
    the one record, which closes when the outer span closes."""
    S.clear()
    with S.span("ingest"):
        S.count("ingest.bytes_fed", 5)
    assert len(S.records()) == 0
    with S.span("ingest"):
        S.count("ingest.bytes_fed", 7)
        with S.span("superblock"):
            pass
        assert len(S.records()) == 0
    rec = S.records()
    assert len(rec) == 1 and rec["ingest.bytes_fed"][0] == 12
    assert rec["calls"][0, S.SPANS.index("ingest")] == 2
    assert rec["ingest"][0] >= rec["superblock"][0]
    S.clear()
