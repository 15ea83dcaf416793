"""The port's host MAC pool (rx/hostpool.MacPool, the receiver's
mac_workers) against the port's in-process MAC stack and against the JAX
package's pool and in-process stack, on the same bit streams.

Bits go straight into burst sync (no demod), so every comparison is exact:
display state, CRC tallies, event logs (kinds, TDMA times, reassembled SDU
payloads), the parent's PhyState, voice PCM and the SDUs a keystore
decrypts.  The pool's workers decode on the CPU, as the reference pins
them; its parent's FEC runs here on the CPU too (device="cpu")."""

import numpy as np
import pytest

from tetra_tpu.crypto.state import CryptoState as JCryptoState
from tetra_tpu.crypto.state import KeyStore as JKeyStore
from tetra_tpu.rx.burst_sync import BurstSync as JBurstSync
from tetra_tpu.rx.hostpool import MacPool as JMacPool
from tetra_tpu.rx.lower_mac import LowerMac as JLowerMac
from tetra_tpu.rx.lower_mac import process_bursts_multi as jprocess
from tetra_tpu.rx.tdma import PhyState as JPhyState
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell as JCELL
from tetra_tpu.voice.pipeline import VoicePipeline as JPipeline
from tetra_tpu_torch.crypto.state import CryptoState as TCryptoState
from tetra_tpu_torch.crypto.state import KeyStore as TKeyStore
from tetra_tpu_torch.rx.burst_sync import BurstSync
from tetra_tpu_torch.rx.hostpool import MacPool
from tetra_tpu_torch.rx.lower_mac import LowerMac, process_bursts_multi
from tetra_tpu_torch.rx.tdma import PhyState
from tetra_tpu_torch.tx.wideband import cell_keystore
from tetra_tpu_torch.voice.pipeline import VoicePipeline
from tests.test_hostpool import _mk_streams
from tests.test_torch_mac import _plain
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401
from tests.test_torch_receiver_voice import decrypt_halves

FEED = 4096


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one torch thread each (the
    suite's processes share the cores; results do not depend on it)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _feeds(bits):
    return range(0, bits.shape[1] - FEED, FEED)


def _inprocess(bits, jax: bool = False, voice: bool = False,
               keystore: str | None = None):
    """Per-channel burst sync + LowerMac in this process (the port's on the
    CPU, or the JAX package's); returns (macs, phys, pipelines)."""
    C = bits.shape[0]
    if jax:
        phys = [JPhyState() for _ in range(C)]
        syncs = [JBurstSync(phy=p) for p in phys]
        macs = [JLowerMac(phy=p) for p in phys]
    else:
        phys = [PhyState() for _ in range(C)]
        syncs = [BurstSync(phy=p) for p in phys]
        macs = [LowerMac(phy=p, device="cpu") for p in phys]
    pipes = []
    for m in macs:
        if keystore:
            m.upper.crypto_state = (
                JCryptoState(JKeyStore.load(keystore)) if jax else
                TCryptoState(TKeyStore.load(keystore)))
        if voice:
            vp = decrypt_halves(JPipeline()) if jax \
                else VoicePipeline(device="cpu")
            vp.crypto_state = m.upper.crypto_state
            m.voice_cb = vp
            pipes.append(vp)
    for i in _feeds(bits):
        fm, fb = [], []
        for c in range(C):
            bs = syncs[c].feed(bits[c, i:i + FEED])
            if bs:
                fm.append(macs[c])
                fb.append(bs)
        if fm:
            (jprocess if jax else process_bursts_multi)(fm, fb)
    return macs, phys, pipes


def _pooled(bits, workers: int, jax: bool = False, **kw):
    """Burst sync here, the MAC in a pool of `workers` processes (the
    port's, parent FEC on the CPU, or the JAX package's).  Returns
    (views, phys, pcm)."""
    C = bits.shape[0]
    Phy, Sync = (JPhyState, JBurstSync) if jax else (PhyState, BurstSync)
    phys = [Phy() for _ in range(C)]
    syncs = [Sync(phy=p) for p in phys]
    pool = JMacPool(C, workers=workers, **kw) if jax else \
        MacPool(C, workers=workers, device="cpu", **kw)
    try:
        pcm = []
        for i in _feeds(bits):
            ids, ph, fb = [], [], []
            for c in range(C):
                bs = syncs[c].feed(bits[c, i:i + FEED])
                if bs:
                    ids.append(c)
                    ph.append(phys[c])
                    fb.append(bs)
            if ids:
                pool.process_bursts(ph, ids, fb)
            pcm.append(pool.take_audio())
        return pool.views, phys, np.concatenate(pcm)
    finally:
        pool.close()
        assert not any(p.is_alive() for p in getattr(pool, "_procs", []))


def _times(events):
    return [(e[0], e[1].mn, e[1].fn, e[1].tn) for e in events]


def test_pool_matches_inprocess_and_jax_pool():
    """4 channels, 2 workers: the port's pool equals the port's in-process
    stack and the JAX pool in display, CRC tallies, event kinds and times,
    reassembled SDU payloads and the parent's PhyState."""
    bits, cfgs = _mk_streams(4)
    macs, phys_a, _ = _inprocess(bits)
    views, phys_b, _ = _pooled(bits, 2)
    jviews, jphys, _ = _pooled(bits, 2, jax=True)
    for c in range(4):
        da = macs[c].upper.display.as_dict()
        assert views[c].display == da == jviews[c].display, c
        assert views[c].display["mcc"] == cfgs[c].mcc
        assert (views[c].crc_oks, views[c].crc_fails) == (
            macs[c].crc_oks, macs[c].crc_fails) == (
            jviews[c].crc_oks, jviews[c].crc_fails), c
        ev_a, ev_b, ev_j = (macs[c].upper.events, views[c].events,
                            jviews[c].events)
        assert _times(ev_b) == _times(ev_a) == _times(ev_j), c
        assert _plain(ev_b) == _plain(ev_a) == _plain(ev_j), c
        sdus = [e[2] for e in ev_b if e[0] == "tm_sdu_reassembled"]
        assert len(sdus) >= 1
        for x, y in zip(sdus, [e[2] for e in ev_j
                               if e[0] == "tm_sdu_reassembled"]):
            np.testing.assert_array_equal(x, y)
        snap = lambda p: (p.slot_count, str(p.time))
        assert snap(phys_b[c]) == snap(phys_a[c]) == snap(jphys[c]), c


def test_pool_voice_audio_matches_jax():
    """Worker-side voice pipelines (on the CPU) give the PCM of the port's
    and of the JAX package's in-process pipelines."""
    bits, _ = _mk_streams(1)
    _, _, pipes = _inprocess(bits, voice=True)
    _, _, jpipes = _inprocess(bits, jax=True, voice=True)
    views, _, pcm = _pooled(bits, 1, voice=True)
    want = jpipes[0].take_audio()
    assert len(want) > 0 and len(want) % 480 == 0
    np.testing.assert_array_equal(pcm, want)
    np.testing.assert_array_equal(pipes[0].take_audio(), want)


def test_pool_keystore_decrypts_like_jax(tmp_path):
    """A TEA1 cell (tx.cell's crypto arm) with voice: the pool's keystore=
    decrypts the same SDUs and voice as a JAX in-process MAC holding a
    CryptoState from the same keystore (its pipeline decrypting stolen
    halves as the port's does, decrypt_halves)."""
    keys = str(tmp_path / "keys.txt")
    with open(keys, "w") as f:
        f.write(cell_keystore([1]))
    cfg = JCELL.CellConfig(mcc=262, mnc=101, cc=2)
    tx = JCryptoState(store=JKeyStore.load(keys))
    tx.cc, tx.la, tx.cn, tx.hn, tx.cck_id = (cfg.cc, cfg.la, cfg.main_carrier,
                                             cfg.hyperframe, 3)
    tx.update_network(cfg.mcc, cfg.mnc)
    rng = np.random.default_rng(12)
    bits, _ = JCELL.downlink_bits(
        cfg, 300, start=TdmaTime(mn=1, fn=15, tn=1),
        payload_rng=np.random.default_rng(13),
        voice_slots={2: lambda: rng.integers(0, 2, (2, 137)).astype(
            np.uint8)}, stolen_slots={(4, 2): "first"}, crypto=tx)
    bits = bits[None]
    jmacs, _, jpipes = _inprocess(bits, jax=True, voice=True, keystore=keys)
    views, _, pcm = _pooled(bits, 1, voice=True, keystore=keys)
    decrypted = lambda ev: [e for e in ev if e[0] == "llc"
                            and e[3] is not None
                            and e[3].pdu_name == "D-SDS DATA"]
    got, want = decrypted(views[0].events), decrypted(jmacs[0].upper.events)
    assert len(want) > 0
    assert _plain(got) == _plain(want)
    assert _plain(views[0].events) == _plain(jmacs[0].upper.events)
    assert views[0].display == jmacs[0].upper.display.as_dict()
    np.testing.assert_array_equal(pcm, jpipes[0].take_audio())
    assert len(pcm) > 0
