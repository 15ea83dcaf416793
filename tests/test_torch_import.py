"""The PyTorch port never imports jax: every tetra_tpu_torch module (and
chip_smoke.py) imports in a fresh interpreter where importing jax raises."""

import os
import pkgutil
import subprocess
import sys

import pytest

import tetra_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = """
import importlib, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib'):
            raise ImportError('jax is blocked: ' + name)
sys.meta_path.insert(0, _NoJax())
for m in sys.argv[1:]:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib'))
assert not bad, bad
print('imported', len(sys.argv) - 1)
"""


def _modules():
    mods = ["tetra_tpu_torch"]
    for info in pkgutil.walk_packages(tetra_tpu_torch.__path__,
                                      "tetra_tpu_torch."):
        mods.append(info.name)
    return sorted(mods)


def _run(mods):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", _BLOCK] + mods, cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_covers_the_slice_layout():
    mods = set(_modules())
    for m in ("core.fir", "rx.demod", "rx.demod_fast", "rx.viterbi",
              "rx.fec", "rx.fleet", "rx.receiver", "ops._build",
              "ops.demod_kernel", "ops.mm_kernel", "ops.chan_kernel",
              "parallel.channelizer", "tx.wideband", "convert",
              "rx.burst_sync", "rx.lower_mac", "rx.upper_mac", "rx.mac_pdu",
              "rx.llc", "rx.mle", "rx.native_mac", "ops.train_corr",
              "crypto.tea_tables", "crypto.tea", "crypto.hurdle_tables",
              "crypto.hurdle", "crypto.taa1", "crypto.state",
              "voice.acelp", "voice.channel", "voice.pipeline",
              "voice.audio_out", "core.loops", "rx.demod_ff",
              "tx.modulator", "tx.channel", "tx.modulator2",
              "runtime.iq_stream", "apps.tetra_rx", "apps.tetra_tx",
              "rx.hostpool", "parallel.mesh", "apps.multihost",
              "rx.parity"):
        assert "tetra_tpu_torch." + m in mods, m


@pytest.mark.parametrize("group", ["package", "chip_smoke"])
def test_imports_without_jax(group):
    mods = _modules() if group == "package" else ["chip_smoke"]
    res = _run(mods)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"imported {len(mods)}" in res.stdout


_ISOLATED = """
import importlib, os, sys
class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'tetra_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, _Blocked())
for m in sys.argv[1:]:
    importlib.import_module(m)
import numpy as np
from tetra_tpu_torch.rx import fleet, native_mac
from tetra_tpu_torch.rx.burst_sync import BurstSync
from tetra_tpu_torch.rx.lower_mac import LowerMac
from tetra_tpu_torch.tx.cell import CellConfig, downlink_bits
from tetra_tpu_torch.tx.wideband import cell_air
wide = cell_air(4, 0.1, 2)
assert wide.dtype.name == 'complex64' and wide.ndim == 1 and len(wide) > 0
pkg = os.path.dirname(os.path.abspath(fleet.__file__ + '/..'))
for src in (fleet._SRC, fleet._SRC_DEP, native_mac._SRC):
    assert os.path.commonpath([os.path.abspath(src), pkg]) == pkg, src
# one burst-sync + lower/upper MAC decode (native dispatch) of a cell
bits, _ = downlink_bits(CellConfig(mcc=262, mnc=77, cc=5), 160)
mac = LowerMac(device='cpu')
mac.upper.events_enabled = False
sync = BurstSync(phy=mac.phy)
for i in range(0, len(bits), 4608):
    mac.process_bursts(sync.feed(bits[i:i + 4608]))
assert mac.upper.display.mnc == 77 and mac.crc_oks > 100, mac.crc_oks
assert isinstance(mac.upper.__dict__['_native'], native_mac.NativeMacHandle)
# one speech slot through the channel decoder and the ACELP codec, and a
# TEA1 keystream
from tetra_tpu_torch.crypto import tea
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.voice import channel
from tetra_tpu_torch.voice.pipeline import VoicePipeline
frames = np.random.default_rng(1).integers(0, 2, (2, 137)).astype(np.uint8)
vp = VoicePipeline(device='cpu')
vp(TdmaTime(mn=1, fn=2, tn=2), channel.encode_slot(frames.reshape(-1)))
assert vp.slots_decoded == 1 and vp.bad_frames == 0
assert vp.take_audio().shape == (480,)
assert len(tea.tea1(0x1234, bytes(range(10)), 8)) == 8
# one ff block and one exact block of modulated air on the CPU
from tetra_tpu_torch.rx import demod, demod_ff
from tetra_tpu_torch.tx.modulator import modulate
iq = modulate(np.random.default_rng(2).integers(0, 2, (2, 2048)),
              device='cpu').numpy()
for mod, T in ((demod_ff, 1024), (demod, 512)):
    st, o = mod.demod_block(mod.demod_init(2, 'cpu'), iq[:, :T])
    assert int(o['valid'].sum()) > 0.4 * T, mod
# the fleet's packed FEC decode in one pass and chunked, and a pipelined
# pcie fleet receiver with the engine's accessors
import torch
from tetra_tpu_torch import params as P
from tetra_tpu_torch.rx import demod_fast, fec
from tetra_tpu_torch.rx.receiver import TetraReceiver
assert demod_fast.max_symbols(4608) == demod_fast.n_chunks_for(4608) * 32
ks = torch.from_numpy(np.stack([fec.keystream(P.SCRAMB_INIT, 432)] * 2))
t5p = np.random.default_rng(3).integers(0, 256, (12, 54)).astype(np.uint8)
types = np.array([P.TPSAP_T_SB1, P.TPSAP_T_NDB, P.TPSAP_T_SCH_F,
                  P.TPSAP_T_BBK] * 3)
idx = np.zeros(12, np.int32)
one = fec.decode_rows_typed_packed(t5p, types, idx, ks)
fec._MAX_CHUNK_ROWS = 2
chunked = fec.decode_rows_typed_packed(t5p, types, idx, ks)
fec._MAX_CHUNK_ROWS = 1 << 18
assert all((a == b).all() for a, b in zip(one, chunked))
rx = TetraReceiver(wideband=8, fleet=True, wb_k=2, link_profile='pcie',
                   device='cpu')
assert rx.wb_pipeline and rx.fleet.link_profile == 'pcie'
rx.process_wideband(cell_air(8, 1.2, 2))
rx.flush_wideband()
assert any(rx.locked(c) for c in range(8))
assert rx.fleet.chan(0).state == 2 or not rx.locked(0)
assert rx.fleet.lock_losses(0) >= 0 and rx.fleet.phy_time(0).tn >= 0
# slice_marginal's fleet-vs-per-channel step at 8 carriers: marginal air
# (7.5-12 dB, carrier 7 drops out and comes back as another cell) through
# a superblock fleet, a one-cycle fleet and the per-channel receiver
from tests.torch_parity import assert_wide_parity, wide_receivers
from tetra_tpu_torch.tx.wideband import marginal_air
air, plan = marginal_air(8, 1.8, dropout_at=0.6, seed=5, device='cpu')
assert plan['handover'].sum() == 1 and air.dtype.name == 'complex64'
rx_k, rx_1, rx_p, fed = wide_receivers(air, 8, 1600, 2)
assert_wide_parity(rx_k, rx_1, rx_p)
assert len(fed) > 0.9 * len(air)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'tetra_tpu'))
assert not bad, bad
print('isolated', len(sys.argv) - 1, len(wide))
"""


def test_runs_without_jax_or_tetra_tpu():
    """With jax and the JAX package both blocked: every port module and
    chip_smoke import, the cell_air fixture runs (4 channels, 0.1 s), the
    C++ sources of the fleet engine and of the native MAC lie inside
    tetra_tpu_torch/, a BurstSync + LowerMac decode of a cell runs, and so
    do a speech slot's decode and synthesis, a TEA1 keystream, one block
    each of the ff and exact demod chains, the fleet's typed, split and
    mixed packed FEC decodes in chunks, a pipelined pcie fleet
    receiver over 1.2 s of air, and chip_smoke.py slice_marginal's
    fleet-vs-per-channel parity step (tests/torch_parity.py) on 1.8 s of
    tx.wideband.marginal_air at 8 carriers."""
    mods = _modules() + ["chip_smoke"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _ISOLATED] + mods, cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"isolated {len(mods)}" in res.stdout
