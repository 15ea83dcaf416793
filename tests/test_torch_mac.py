"""The port's host MAC stack (rx/mac_pdu, llc, mle, upper_mac, lower_mac and
the native core native_mac) against tetra_tpu's on the same bit streams.

Streams come from the JAX package's tx/cell.downlink_bits (its voice and
slot-stealing arms included) and go through each package's BurstSync and
LowerMac; the port decodes on the CPU.  Everything here is bits and
integers, so every comparison is exact: bursts, CRC tallies, cell data,
display state, last SYSINFO, the event logs and the voice callbacks."""

import dataclasses

import numpy as np
import pytest

from tetra_tpu.rx import burst_sync as JBS
from tetra_tpu.rx import lower_mac as JLM
from tetra_tpu.rx.tdma import TdmaTime as JTdmaTime
from tetra_tpu.tx import cell as JCELL
from tetra_tpu_torch.ops import _build
from tetra_tpu_torch.rx import burst_sync as TBS
from tetra_tpu_torch.rx import lower_mac as TLM
from tetra_tpu_torch.rx import native_mac as TNM
from tetra_tpu_torch.rx import upper_mac as TUM
from tetra_tpu_torch.rx.tdma import TdmaTime
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

BLK = 4608


def _plain(x):
    """A package-free image of x: dataclasses by class name and fields,
    arrays by dtype, shape and bytes, containers item by item."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_plain(v) for v in x])
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def _stream(kind: str, seed: int = 77):
    """A downlink bit stream: "signalling" (SYNC, SYSINFO, NDB traffic and
    a fragmented SDU) or "voice" (the same plus two traffic timeslots with
    both-halves and first-half slot stealing)."""
    rng = np.random.default_rng(seed)
    kw = dict(frag_message=((5, 1), rng.integers(0, 2, 280).astype(np.uint8)))
    if kind == "voice":
        frames = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
        kw.update(voice_slots={2: frames, 3: frames},
                  stolen_slots={(3, 2): "both", (7, 2): "first",
                                (11, 3): "first"})
    bits, _ = JCELL.downlink_bits(JCELL.CellConfig(), 290, **kw)
    return bits


def _voice_log():
    calls = []

    def cb(time, type4):
        calls.append(("full", str(time), np.asarray(type4).copy()))

    def half(time, type4):
        calls.append(("half", str(time), np.asarray(type4).copy()))

    cb.half = half
    return cb, calls


def _burst_tuple(b):
    return (b.train_seq, b.bits.tobytes(), vars(b.time), b.slot_index)


def _mac_state(m):
    c = m.cell
    return (m.crc_oks, m.crc_fails, c.mcc, c.mnc, c.colour_code,
            c.scramb_init, vars(c.time), vars(m.phy.time), m.phy.slot_count,
            m.upper.display.as_dict(), m.upper.is_traffic,
            m.upper.blk1_stolen, m.upper.blk2_stolen, m.upper.ssi,
            m.upper.usage_marker, m.upper.addr_type)


@pytest.mark.parametrize("kind", ["signalling", "voice"])
@pytest.mark.parametrize("events", [True, False])
def test_mac_stack_matches_jax(kind, events):
    """BurstSync + LowerMac of both packages, block by block: with
    events=True the Python upper MAC (event logs compared), with
    events=False the native dispatch."""
    bits = _stream(kind)
    jcb, jcalls = _voice_log()
    tcb, tcalls = _voice_log()
    jm = JLM.LowerMac(voice_cb=jcb)
    tm = TLM.LowerMac(voice_cb=tcb, device="cpu")
    jm.upper.events_enabled = tm.upper.events_enabled = events
    js, ts = JBS.BurstSync(phy=jm.phy), TBS.BurstSync(phy=tm.phy)
    for b in range(len(bits) // BLK):
        chunk = bits[b * BLK:(b + 1) * BLK]
        jb, tb = js.feed(chunk), ts.feed(chunk)
        assert [_burst_tuple(x) for x in tb] == [_burst_tuple(x) for x in jb]
        JLM.process_bursts_multi([jm], [jb])
        TLM.process_bursts_multi([tm], [tb])
        assert _mac_state(tm) == _mac_state(jm), b
    assert tm.crc_oks > 100
    assert _plain(tm.upper.last_sysinfo) == _plain(jm.upper.last_sysinfo)
    assert tm.upper.last_sysinfo is not None
    assert len(tcalls) == len(jcalls)
    for (kt, tt, bt), (kj, tj, bj) in zip(tcalls, jcalls):
        assert (kt, tt) == (kj, tj)
        np.testing.assert_array_equal(bt, bj)
    if kind == "voice":
        assert {k for k, _, _ in tcalls} == {"full", "half"}
    if events:
        assert _plain(tm.upper.events) == _plain(jm.upper.events)
        kinds = {e[0] for e in tm.upper.events}
        assert {"sysinfo", "resource", "aach", "llc"} <= kinds, kinds
    else:
        assert tm.upper.events == []
        h = tm.upper.__dict__.get("_native")
        assert isinstance(h, TNM.NativeMacHandle)


def test_native_library_built_from_the_port():
    """The native core is the port's own build of csrc/host/macparse.cpp
    into the build directory, and its state struct matches the mirror."""
    lib = TNM.load()
    assert lib is not None
    pkg = _build._PKG
    assert TNM._SRC.startswith(pkg + "/csrc/host/")
    assert lib._name.startswith(_build.BUILD_DIR + "/libtetra_macparse_")
    assert lib.macparse_state_size() == TNM.ctypes.sizeof(TNM.MacStateStruct)


def test_native_switch_selects_the_python_loop(monkeypatch):
    monkeypatch.setenv("TETRA_NO_NATIVE_MAC", "1")
    assert TNM.load() is None
    um = TUM.UpperMac(events_enabled=False)
    um.receive(np.zeros(40, np.uint8), TUM.LC_AACH, True, TdmaTime())
    assert um.__dict__["_native"] is False


def _state_tuple(u):
    return (u.is_traffic, u.blk1_stolen, u.blk2_stolen, u.ssi,
            u.usage_marker, u.addr_type)


def _frag_tuple(u):
    h = u.__dict__.get("_native")
    if h not in (None, False) and not u.events_enabled:
        return tuple((int(f.active), int(f.age), int(f.num_frags),
                      int(f.length)) for f in h.st.frags)
    return tuple((int(f.active), f.age, f.num_frags, f.length)
                 for f in u.fragslots)


def test_native_receive_matches_python_on_fuzz_blocks():
    """Random blocks over every logical channel, length and time through
    the native receive core and the Python loop (the reference's
    tests/test_native_mac.py fuzz), state compared after every block."""
    rng = np.random.default_rng(77)
    py, nat = TUM.UpperMac(), TUM.UpperMac(events_enabled=False)
    t = TdmaTime(tn=1, fn=1, mn=1)
    for i in range(600):
        n = int(rng.integers(14, 269))
        bits = rng.integers(0, 2, n).astype(np.uint8)
        lchan = int(rng.choice([TUM.LC_AACH, TUM.LC_BNCH, TUM.LC_SCH_F, 0]))
        if lchan == TUM.LC_AACH:
            bits = bits[:14]
        ok = bool(rng.integers(0, 4))
        py.receive(bits, lchan, ok, t.copy())
        nat.receive(bits, lchan, ok, t.copy())
        assert _state_tuple(py) == _state_tuple(nat), i
        assert py.display.as_dict() == nat.display.as_dict(), i
        assert _frag_tuple(py) == _frag_tuple(nat), i
        t.add_tn(1)
    assert isinstance(nat.__dict__.get("_native"), TNM.NativeMacHandle)


def _cell_stream(mnc: int, cc: int, start_fn: int):
    bits, _ = JCELL.downlink_bits(
        JCELL.CellConfig(mcc=262, mnc=mnc, cc=cc), 200,
        start=JTdmaTime(mn=1, fn=start_fn, tn=2))
    return bits


@pytest.mark.parametrize("events", [True, False])
def test_process_bursts_multi_matches_jax(events, monkeypatch):
    """Four channels of three cells in one batched FEC pass per feed,
    large feeds so a batch holds a channel's first good SYNC PDU and the
    blocks decoded before it under the stale scrambling code: the re-decode
    pass must run and every channel must end equal to the JAX package's."""
    streams = [_cell_stream(100 + (c % 3), 1 + c, 17 - c) for c in range(4)]
    L = min(len(s) for s in streams)
    jms = [JLM.LowerMac() for _ in streams]
    tms = [TLM.LowerMac(device="cpu") for _ in streams]
    for m in jms + tms:
        m.upper.events_enabled = events
    jss = [JBS.BurstSync(phy=m.phy) for m in jms]
    tss = [TBS.BurstSync(phy=m.phy) for m in tms]
    passes = []
    orig = TLM.rx_fec.decode_blocks_mixed
    monkeypatch.setattr(TLM.rx_fec, "decode_blocks_mixed",
                        lambda rows, dev: passes.append(len(rows))
                        or orig(rows, dev))
    feeds = 0
    for i in range(0, L, 3 * BLK):
        jb = [s.feed(x[i:i + 3 * BLK]) for s, x in zip(jss, streams)]
        tb = [s.feed(x[i:i + 3 * BLK]) for s, x in zip(tss, streams)]
        JLM.process_bursts_multi(jms, jb)
        TLM.process_bursts_multi(tms, tb)
        feeds += 1
        for c in range(4):
            assert _mac_state(tms[c]) == _mac_state(jms[c]), (i, c)
    assert len(passes) > feeds, "no stale-code re-decode pass ran"
    for c, m in enumerate(tms):
        assert m.cell.mnc == 100 + c % 3 and m.crc_oks > 100, c
    if events:
        for tm, jm in zip(tms, jms):
            assert _plain(tm.upper.events) == _plain(jm.upper.events)


def test_crypto_state_is_a_field_holding_a_crypto_state():
    """UpperMac.crypto_state is the reference's dataclass field: None by
    default, and it holds the port's CryptoState once set."""
    from tetra_tpu_torch.crypto.state import CryptoState
    assert "crypto_state" in {f.name for f in dataclasses.fields(TUM.UpperMac)}
    um = TUM.UpperMac()
    assert um.crypto_state is None
    cs = CryptoState()
    um.crypto_state = cs
    assert um.crypto_state is cs
    assert TUM.UpperMac(crypto_state=cs).crypto_state is cs


def test_lower_mac_needs_a_device_without_cuda():
    """With no device= the lower MAC's FEC runs on the current CUDA
    device, and without CUDA it raises rather than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        assert TLM.LowerMac().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TLM.LowerMac()