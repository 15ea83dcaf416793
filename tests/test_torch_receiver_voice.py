"""Voice and crypto through the port's narrowband receivers against
tetra_tpu's, on the same air: two carriers at 36 ksps, a clear cell and a
TEA1-encrypted cell, each with voice on timeslot 2 and stolen slots of
both kinds.

Per-channel receiver (TetraReceiver(channels=2)): one VoicePipeline per
channel, the encrypted channel's cipher state loaded from a keystore file
(as the CLI builds it) on its upper MAC and its pipeline.  Audio, slot and
bad-frame counts, CRC tallies and event logs must be equal, the JAX
pipelines given the port's one departure (decrypt_halves: a stolen
slot's surviving frame decrypted with keystream bits 137-273).  Fleet
receiver: the shared voice_cb must get the same calls.  The air is clean
(no noise), so both packages' demods slice the same dibits."""

import numpy as np
import pytest

from tetra_tpu.crypto.state import CryptoState as JCryptoState
from tetra_tpu.crypto.state import KeyStore as JKeyStore
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell as JCELL
from tetra_tpu.voice import channel as JVC
from tetra_tpu.voice.pipeline import VoicePipeline as JPipeline
from tetra_tpu_torch.crypto.state import CryptoState as TCryptoState
from tetra_tpu_torch.crypto.state import KeyStore as TKeyStore
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx.wideband import _shaped, cell_keystore
from tetra_tpu_torch.voice.pipeline import VoicePipeline as TPipeline
from tests.test_torch_mac import _plain
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

BLK = 4608
N_BLOCKS = 16
CFO_HZ = (60.0, -90.0)
ENCRYPTED = 1          # carrier 1 carries the TEA1 cell


def decrypt_halves(vp):
    """A JAX pipeline whose half() decrypts the surviving frame of a stolen
    slot with keystream bits 137-273, as the port's VoicePipeline.half does
    (the JAX package's decrypts no half); vp, changed in place."""
    def half(time, type4):
        if not vp._gate(time):
            return
        frame, bfi = JVC.decode_half_slot(np.asarray(type4)[None],
                                          profile=vp.profile)
        cs = vp.crypto_state
        ks = cs.keystream_bits(cs.cck, time, 274) \
            if cs is not None and cs.cck else None
        if ks is not None:
            frame[0] ^= ks[137:]
        vp.slots_decoded += 1
        vp.bad_frames += int(bfi[0])
        vp.audio += [np.zeros(240, np.int16),
                     vp.decoder.decode_frame(frame[0], bfi=bool(bfi[0]))]
    vp.half = half
    return vp


def _cell_cfg(c: int):
    return JCELL.CellConfig(mcc=262, mnc=100 + c, cc=1 + c)


@pytest.fixture(scope="module")
def air(tmp_path_factory):
    """(iq (N_BLOCKS, 2, BLK) complex64, keystore path)."""
    keys = str(tmp_path_factory.mktemp("keys") / "keys.txt")
    with open(keys, "w") as f:
        f.write(cell_keystore([ENCRYPTED]))
    rows = []
    n = N_BLOCKS * BLK
    for c in range(2):
        cfg = _cell_cfg(c)
        crypto = None
        if c == ENCRYPTED:
            crypto = JCryptoState(store=JKeyStore.load(keys))
            crypto.cc, crypto.la, crypto.cn, crypto.hn, crypto.cck_id = (
                cfg.cc, cfg.la, cfg.main_carrier, cfg.hyperframe, 3)
            crypto.update_network(cfg.mcc, cfg.mnc)
        rng = np.random.default_rng(40 + c)
        bits, _ = JCELL.downlink_bits(
            cfg, n // 510 + 2, start=TdmaTime(mn=1, fn=15, tn=1),
            payload_rng=np.random.default_rng(50 + c),
            voice_slots={2: lambda: rng.integers(0, 2, (2, 137)).astype(
                np.uint8)},
            stolen_slots={(4, 2): "first", (8, 2): "both",
                          (13, 2): "first"},
            crypto=crypto)
        up, h = _shaped(bits[:n])
        ext = np.concatenate([np.zeros(len(h) - 1, np.complex64), up])
        x = np.convolve(ext, h, mode="valid")[:n]
        x = x * np.exp(2j * np.pi * CFO_HZ[c] * np.arange(n) / 36_000)
        rows.append(x.astype(np.complex64))
    iq = np.stack(rows).reshape(2, N_BLOCKS, BLK).transpose(1, 0, 2)
    return np.ascontiguousarray(iq), keys


def _run(pkg: str, iq, keys):
    """A per-channel receiver of pkg with a pipeline on each channel."""
    if pkg == "port":
        rx = TetraReceiver(channels=2, device="cpu")
        pipes = [TPipeline(device="cpu") for _ in range(2)]
        cs = TCryptoState(store=TKeyStore.load(keys))
    else:
        rx = JaxReceiver(channels=2)
        pipes = [decrypt_halves(JPipeline()) for _ in range(2)]
        cs = JCryptoState(store=JKeyStore.load(keys))
    rx.mac[ENCRYPTED].upper.crypto_state = cs
    pipes[ENCRYPTED].crypto_state = cs
    for m, vp in zip(rx.mac, pipes):
        m.voice_cb = vp
    for block in iq:
        rx.process(block)
    return rx, pipes


def test_per_channel_voice_and_crypto_match_jax(air):
    iq, keys = air
    got, gp = _run("port", iq, keys)
    ref, rp = _run("jax", iq, keys)
    for c in range(2):
        assert got.locked(c) and got.display(c).mnc == 100 + c, c
        assert got.crc_counts(c) == ref.crc_counts(c), c
        assert got.display(c).as_dict() == ref.display(c).as_dict(), c
        assert _plain(got.mac[c].upper.events) == \
            _plain(ref.mac[c].upper.events), c
        assert (gp[c].slots_decoded, gp[c].bad_frames) == \
            (rp[c].slots_decoded, rp[c].bad_frames), c
        assert gp[c].slots_decoded > 15 and gp[c].bad_frames == 0, c
        audio = gp[c].take_audio()
        assert len(audio) == 480 * gp[c].slots_decoded
        np.testing.assert_array_equal(audio, rp[c].take_audio())
    # the encrypted cell's SDUs were decrypted (LLC events surface), and
    # its cipher state learned the cell from SYNC and SYSINFO
    llc = [e for e in got.mac[ENCRYPTED].upper.events
           if e[0] == "llc" and e[3] is not None
           and e[3].pdu_name == "D-SDS DATA"]
    assert llc
    cs = got.mac[ENCRYPTED].upper.crypto_state
    cfg = _cell_cfg(ENCRYPTED)
    assert (cs.mcc, cs.mnc, cs.cc, cs.la, cs.cn) == (
        cfg.mcc, cfg.mnc, cfg.cc, cfg.la, cfg.main_carrier)


def test_fleet_voice_cb_gets_the_same_calls(air):
    """The fleet receivers' shared voice callback (full slots and, through
    its .half, the stolen halves): the same calls, times and bits."""
    iq, _ = air

    def log():
        calls = []
        cb = lambda t, type4: calls.append(("full", str(t),
                                            np.asarray(type4).copy()))
        cb.half = lambda t, type4: calls.append(("half", str(t),
                                                 np.asarray(type4).copy()))
        return cb, calls

    tcb, tcalls = log()
    jcb, jcalls = log()
    got = TetraReceiver(channels=2, fleet=True, voice_cb=tcb, device="cpu")
    ref = JaxReceiver(channels=2, fleet=True, events=False, voice_cb=jcb)
    for block in iq:
        got.process(block)
        ref.process(block)
    assert len(tcalls) == len(jcalls) > 20
    assert {k for k, _, _ in tcalls} == {"full", "half"}
    for (kt, tt, bt), (kj, tj, bj) in zip(tcalls, jcalls):
        assert (kt, tt) == (kj, tj)
        np.testing.assert_array_equal(bt, bj)
