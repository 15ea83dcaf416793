"""The port's air-interface crypto (crypto/tea, hurdle, taa1, state) and
its hooks in the lower/upper MAC and the voice pipeline, against
tetra_tpu's: keystreams, HURDLE, TAA1, TB5, build_iv and KeyStore.load
equal on seeded inputs (package against package: the reference's C
oracle is not in the repo), and the encrypted downlink through each
package's BurstSync + LowerMac with equal events and voice frames."""

import dataclasses
import os

import numpy as np
import pytest

from tetra_tpu.crypto import hurdle as JH
from tetra_tpu.crypto import state as JS
from tetra_tpu.crypto import taa1 as JT
from tetra_tpu.crypto import tea as JTEA
from tetra_tpu.rx import burst_sync as JBS
from tetra_tpu.rx import lower_mac as JLM
from tetra_tpu.rx.tdma import TdmaTime as JTdmaTime
from tetra_tpu.tx import cell as JCELL
from tetra_tpu.voice import channel as JV
from tetra_tpu.voice.pipeline import VoicePipeline as JPipeline
from tetra_tpu_torch.crypto import hurdle as TH
from tetra_tpu_torch.crypto import state as TS
from tetra_tpu_torch.crypto import taa1 as TT
from tetra_tpu_torch.crypto import tea as TTEA
from tetra_tpu_torch.rx import burst_sync as TBS
from tetra_tpu_torch.rx import lower_mac as TLM
from tetra_tpu_torch.rx import native_mac as TNM
from tetra_tpu_torch.rx.tdma import TdmaTime as TTdmaTime
from tetra_tpu_torch.tx import cell as TCELL
from tetra_tpu_torch.voice import channel as TV
from tetra_tpu_torch.voice.pipeline import VoicePipeline as TPipeline
from tests.test_torch_mac import _plain
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module", ["tea_tables", "tea", "hurdle_tables",
                                    "hurdle", "taa1", "state"])
def test_crypto_copy_byte_equal(module):
    """The host-only crypto modules are verbatim copies (their imports are
    package-relative)."""
    paths = [os.path.join(ROOT, pkg, "crypto", module + ".py")
             for pkg in ("tetra_tpu_torch", "tetra_tpu")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("ksg", ["tea1", "tea2", "tea3"])
def test_tea_keystreams_equal(ksg):
    rng = np.random.default_rng(sum(map(ord, ksg)))
    for _ in range(4):
        key = bytes(rng.integers(0, 256, 10, dtype=np.uint8))
        iv = int(rng.integers(0, 1 << 29))
        n = int(rng.integers(1, 80))
        out = getattr(TTEA, ksg)(iv, key, n)
        assert len(out) == n and out == getattr(JTEA, ksg)(iv, key, n)
    assert sorted(TTEA.KSG_FUNCS) == sorted(JTEA.KSG_FUNCS)


def test_hurdle_equal():
    rng = np.random.default_rng(7)
    for _ in range(5):
        key = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        pt = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        assert TH.enc_cbc(pt, key) == JH.enc_cbc(pt, key)
        ct = bytes(rng.integers(0, 256, 15, dtype=np.uint8))
        assert TH.dec_cts(ct, key) == JH.dec_cts(ct, key)


def test_taa1_equal():
    """Every TAA1 function of the reference's oracle test, seeded."""
    rng = np.random.default_rng(8)
    b = lambda n: bytes(rng.integers(0, 256, n, dtype=np.uint8))
    k16, k10, rs, vn, cck_id, gckn = b(16), b(10), b(10), b(2), b(2), b(2)
    cck, gsko = b(10), b(12)
    for name, args in (("ta11_ta41", (k16, rs)), ("ta12_ta22", (k16, rs)),
                       ("ta21", (k16, rs)), ("ta31", (k10, cck_id, rs)),
                       ("ta51", (k10, vn, k16, 0x13)), ("ta71", (k10, cck)),
                       ("ta81", (k10, vn, gckn, k16)),
                       ("tb6", (k10, 1234, 0xABCDEF)), ("tb7", (gsko,))):
        assert getattr(TT, name)(*args) == getattr(JT, name)(*args), name
    sealed = TT.ta31(k10, cck_id, rs)
    assert TT.ta32(sealed, cck_id, rs) == JT.ta32(sealed, cck_id, rs)
    assert TT.ta32(sealed, cck_id, rs) == (k10, False)
    sealed = TT.ta51(k10, vn, k16, 0x13)
    assert TT.ta52(sealed, k16, vn) == JT.ta52(sealed, k16, vn)
    sealed = TT.ta81(k10, vn, gckn, k16)
    assert TT.ta82(sealed, vn, k16) == JT.ta82(sealed, vn, k16)


def test_tb5_and_build_iv_equal():
    rng = np.random.default_rng(1)
    for _ in range(8):
        cn, la, cc = (int(rng.integers(0, 1 << n)) for n in (12, 14, 6))
        ck = bytes(rng.integers(0, 256, 10, dtype=np.uint8))
        assert TS.tb5(cn, la, cc, ck) == JS.tb5(cn, la, cc, ck)
        mn, fn, tn = (int(rng.integers(1, m + 1)) for m in (60, 18, 4))
        hn, d = int(rng.integers(0, 1 << 16)), int(rng.integers(0, 2))
        assert TS.build_iv(TTdmaTime(mn=mn, fn=fn, tn=tn), hn, d) == \
            JS.build_iv(JTdmaTime(mn=mn, fn=fn, tn=tn), hn, d)


KEYSTORE = (
    "# two networks\n"
    "network mcc 262 mnc 1234 ksg_type 1 security_class 2\n"
    "network mcc 901 mnc 7 ksg_type 2 security_class 3\n"
    "\n"
    "key mcc 262 mnc 1234 addr 0 key_type 1 key_num 3 "
    "key 0102030405060708090A\n"
    "key mcc 901 mnc 7 addr 55 key_type 2 key_num 1 "
    "key A0B0C0D0E0F001020304\n")


def test_keystore_load_equal(tmp_path):
    p = tmp_path / "keys.txt"
    p.write_text(KEYSTORE)
    t, j = TS.KeyStore.load(str(p)), JS.KeyStore.load(str(p))
    assert _plain(t) == _plain(j)
    assert t.keys[1].network is t.nets[1]
    bad = tmp_path / "bad.txt"
    bad.write_text("key mcc 1 mnc 1 addr 0 key_type 1 key_num 1 key 00\n")
    for S in (TS, JS):
        with pytest.raises(ValueError, match="no network info"):
            S.KeyStore.load(str(bad))


def _make_state(S, cfg=None):
    """A TEA1 cipher state on the fixture cell's identity (the reference
    test's _make_state)."""
    cfg = cfg or JCELL.CellConfig()
    ks = S.KeyStore()
    ks.nets.append(S.NetInfo(cfg.mcc, cfg.mnc, ksg_type=1, security_class=2))
    ks.keys.append(S.Key(cfg.mcc, cfg.mnc, addr=0,
                         key_type=S.KEYTYPE_CCK_SCK, key_num=3,
                         key=bytes(range(10)), network=ks.nets[0]))
    cs = S.CryptoState(store=ks)
    cs.cc, cs.la, cs.cn, cs.hn, cs.cck_id = (cfg.cc, cfg.la, cfg.main_carrier,
                                             cfg.hyperframe, 3)
    cs.update_network(cfg.mcc, cfg.mnc)
    assert cs.cck is not None
    return cs


def test_crypto_state_operations_equal():
    """keystream_bits, try_decrypt_mac_element (both half slots),
    decrypt_voice_bits and decrypt_voice give equal bits."""
    t, j = _make_state(TS), _make_state(JS)
    rng = np.random.default_rng(5)
    for mn, fn, tn in ((9, 3, 2), (1, 18, 4), (60, 1, 1)):
        tt, jt = TTdmaTime(mn=mn, fn=fn, tn=tn), JTdmaTime(mn=mn, fn=fn, tn=tn)
        np.testing.assert_array_equal(t.keystream_bits(t.cck, tt, 300),
                                      j.keystream_bits(j.cck, jt, 300))
        bits = rng.integers(0, 2, 124).astype(np.uint8)
        for second in (False, True):
            np.testing.assert_array_equal(
                t.try_decrypt_mac_element(bits, tt, 43,
                                          second_half_slot=second),
                j.try_decrypt_mac_element(bits, jt, 43,
                                          second_half_slot=second))
        frames = rng.integers(0, 2, (2, 137)).astype(np.uint8)
        tf, jf = frames.copy(), frames.copy()
        assert t.decrypt_voice_bits(tt, tf) and j.decrypt_voice_bits(jt, jf)
        np.testing.assert_array_equal(tf, jf)
        assert not (tf == frames).all()
        tb, jb = np.full(690, 127, np.int16), np.full(690, 127, np.int16)
        assert t.decrypt_voice(tt, tb) and j.decrypt_voice(jt, jb)
        np.testing.assert_array_equal(tb, jb)
    # no key: nothing decrypts, in either package
    for S, T in ((TS, TTdmaTime), (JS, JTdmaTime)):
        assert S.CryptoState().try_decrypt_mac_element(
            np.zeros(124, np.uint8), T(mn=1, fn=1, tn=1), 43) is None


def _run_downlink(pkg: str, bits, with_keys: bool, events: bool = True,
                  voice: bool = False):
    """Each package's BurstSync + LowerMac (and, with voice, a
    VoicePipeline whose decoded frames are recorded) over the bits."""
    LM, BS, S, Pipe, V = ((TLM, TBS, TS, TPipeline, TV) if pkg == "port"
                          else (JLM, JBS, JS, JPipeline, JV))
    mac = LM.LowerMac(device="cpu") if pkg == "port" else LM.LowerMac()
    mac.upper.events_enabled = events
    sync = BS.BurstSync(phy=mac.phy)
    cs = _make_state(S) if with_keys else None
    mac.upper.crypto_state = cs
    got = []
    if voice:
        vp = (Pipe(crypto_state=cs, device="cpu") if pkg == "port"
              else Pipe(crypto_state=cs))

        def spy(t, type4):
            kw = dict(device="cpu") if pkg == "port" else {}
            frames, _ = V.decode_slot(np.asarray(type4)[None], **kw)
            got.append(((t.mn, t.fn, t.tn), frames[0].copy()))
            vp(t, type4)
        mac.voice_cb = spy
    for i in range(0, len(bits), 510 * 4):
        mac.process_bursts(sync.feed(bits[i:i + 510 * 4]))
    return mac, got, (vp if voice else None)


@pytest.fixture(scope="module")
def encrypted_downlink():
    cfg = JCELL.CellConfig()
    rng = np.random.default_rng(31)
    frames = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
    bits, records = JCELL.downlink_bits(
        cfg, 170, start=JTdmaTime(mn=1, fn=17, tn=4),
        voice_slots={2: frames}, stolen_slots={(5, 2): "first"},
        crypto=_make_state(JS))
    return bits, records


@pytest.mark.parametrize("with_keys", [True, False])
def test_encrypted_downlink_matches_jax(encrypted_downlink, with_keys):
    """TEA1-encrypted MAC-RESOURCE SDUs: with the keystore both packages
    decrypt them to equal LLC/CMCE events; without it the SDUs stay opaque
    alike.  The MAC state, display and event logs are equal block for
    block."""
    bits, _ = encrypted_downlink
    tm, _, _ = _run_downlink("port", bits, with_keys)
    jm, _, _ = _run_downlink("jax", bits, with_keys)
    assert _plain(tm.upper.events) == _plain(jm.upper.events)
    assert tm.upper.display.as_dict() == jm.upper.display.as_dict()
    assert (tm.crc_oks, tm.crc_fails) == (jm.crc_oks, jm.crc_fails)
    llc = [e for e in tm.upper.events if e[0] == "llc"]
    if with_keys:
        good = [e for e in llc if e[2].name == "BL-UDATA"
                and e[3] is not None and e[3].pdu_name == "D-SDS DATA"]
        assert len(good) > 40 and len(good) >= len(llc) - 4
        cs = tm.upper.crypto_state
        assert (cs.mcc, cs.mnc, cs.cc, cs.la, cs.cn) == (262, 1234, 7, 21,
                                                         3600)
    else:
        # only the stolen slot's clear STCH signalling parses
        assert llc and all(e[3].pdu_name == "D-ALERT" for e in llc)
        assert any(e[2].is_encrypted for e in tm.upper.events
                   if e[0] == "resource")


def test_encrypted_voice_matches_jax(encrypted_downlink):
    """Encrypted traffic slots: each package's pipeline, with the cipher
    state wired, hands the codec equal frames; decrypted, they are the
    sent plaintext, and on air they differ from it."""
    bits, records = encrypted_downlink
    sent = {(r.time.mn, r.time.fn, r.time.tn): r.type1["frames"]
            for r in records if r.kind == "voice"}
    tm, tgot, tvp = _run_downlink("port", bits, True, voice=True)
    jm, jgot, jvp = _run_downlink("jax", bits, True, voice=True)
    assert [k for k, _ in tgot] == [k for k, _ in jgot]
    for (key, a), (_, b) in zip(tgot, jgot):
        np.testing.assert_array_equal(a, b)
    matched = 0
    for key, on_air in tgot:
        if key not in sent:
            continue
        plain = on_air.copy()
        assert _make_state(TS).decrypt_voice_bits(
            TTdmaTime(mn=key[0], fn=key[1], tn=key[2], sn=1), plain)
        np.testing.assert_array_equal(plain, sent[key].reshape(2, 137))
        assert not (on_air == sent[key].reshape(2, 137)).all()
        matched += 1
    assert matched >= 8
    assert (tvp.slots_decoded, tvp.bad_frames) == (jvp.slots_decoded,
                                                   jvp.bad_frames)
    np.testing.assert_array_equal(tvp.take_audio(), jvp.take_audio())


def test_crypto_channel_takes_the_python_mac_path(encrypted_downlink):
    """With events=False a channel holding a crypto_state runs the Python
    upper MAC (it decrypts), the others the native core, as in the
    reference; both end in the reference's state."""
    bits, _ = encrypted_downlink
    tm, _, _ = _run_downlink("port", bits, True, events=False)
    jm, _, _ = _run_downlink("jax", bits, True, events=False)
    assert tm.upper.__dict__.get("_native") is None
    assert tm.upper.display.as_dict() == jm.upper.display.as_dict()
    assert tm.upper.crypto_state.cck is not None
    plain, _, _ = _run_downlink("port", bits, False, events=False)
    assert isinstance(plain.upper.__dict__.get("_native"),
                      TNM.NativeMacHandle)
    assert dataclasses.fields(type(tm.upper))[1].name == "crypto_state"


def test_downlink_bits_crypto_records_equal(encrypted_downlink):
    """The port's cell simulator gives the encrypted voice stream bit for
    bit, records included."""
    bits, records = encrypted_downlink
    rng = np.random.default_rng(31)
    frames = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
    tbits, trec = TCELL.downlink_bits(
        TCELL.CellConfig(), 170, start=TTdmaTime(mn=1, fn=17, tn=4),
        voice_slots={2: frames}, stolen_slots={(5, 2): "first"},
        crypto=_make_state(TS))
    np.testing.assert_array_equal(tbits, bits)
    assert _plain(trec) == _plain(records)
