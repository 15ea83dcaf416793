"""The port's mesh (tetra_tpu_torch/parallel/mesh.py) on 1, 2 and 4 gloo
ranks on the CPU against the JAX package's mesh on the conftest's 8
virtual CPU devices, and the multihost launcher's self-test.

Each rank is a process (tests/torch_mesh_ranks.py) that imports nothing
of jax; the ranks meet through a file:// rendezvous in a temporary
directory and run under a time limit.  Bits, counts and packed words must
be equal, on the channels that carry a cell: the multiplexes leave most
carriers empty, and on an empty carrier the demod amplifies the
neighbours' leakage into noise, which any rounding difference decides
(the JAX package's XLA twin and the port's plain versions round
differently, and so does the port's CPU resampler, a matrix product, at
another channel count).  Floats: halo_fir within 1e-5 (the JAX test's
limit); the superblock's float32 dist-sum row within 2e-3 relative
between shard widths (the JAX test's limit); the all-reduced health
scalars within 1e-5 relative of the same sums taken over the gathered
columns.  The JAX twin's dist is the angle error itself where the port
keeps the kernels' |sin| proxy (ROADMAP "Rules for the port"), so dist
and the health are not held against JAX.  The converted state: the
resampler history within the front end's 3e-5, the loop state of the
cells' channels (gain, FLL and Costas frequency, timing) within the demod
tests' 2e-4."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu import params as JP
from tetra_tpu.parallel import mesh as pmesh
from tetra_tpu.rx import fec as jfec
from tetra_tpu_torch import convert
from tetra_tpu_torch.core import taps
from tetra_tpu_torch.core.fir import fir_valid
from tetra_tpu_torch.parallel import mesh as tmesh
from tetra_tpu_torch.rx import demod_fast as TDF
from tetra_tpu_torch.rx import fec as tfec
from tetra_tpu_torch.rx.fleet import FleetEngine
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.tx import cell
from tetra_tpu_torch.tx.modulator import modulate
from tetra_tpu_torch.tx.wideband import (assemble_wideband,
                                         heterogeneous_fleet_iq)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_mesh_ranks.py")
JOBS = {"four": 4, "two": 2, "one": 1}
TIMEOUT = 300
P = jax.sharding.PartitionSpec
pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")


def _air(occupied: dict, n_ch: int, n_slots: int, cfg) -> np.ndarray:
    """(hosts, T) wideband streams: host h carries cfg(h, k) on carriers
    occupied[h] (the JAX mesh tests' multiplexes, made by the port's TX)."""
    start = TdmaTime(mn=1, fn=17, tn=4)
    feeds = []
    for h, ks in occupied.items():
        chans = {k: modulate(cell.downlink_bits(cfg(h, k), n_slots,
                                                start=start.copy())[0][None],
                             device="cpu")[0].numpy() for k in ks}
        feeds.append(assemble_wideband(chans, n_ch, amplitude=0.5,
                                       device="cpu"))
    T = min(len(f) for f in feeds)
    return np.stack([f[:T] for f in feeds])


def _inputs() -> dict:
    rng = np.random.default_rng(3)
    z = dict(halo_x=rng.standard_normal((4, 1024)).astype(np.float32),
             halo_h=taps.root_raised_cosine(65, 0.35, 18000, 36000).astype(
                 np.float32))
    ks = np.zeros((16, 432), np.uint8)
    ks[0] = tfec.keystream(JP.SCRAMB_INIT, 432)
    ks[1] = tfec.keystream(JP.scramb_get_init(262, 77, 3), 432)
    rng = np.random.default_rng(17)
    z.update(fec_t5p=rng.integers(0, 256, (64, 54)).astype(np.uint8),
             fec_ks=ks, fec_tsel=rng.integers(0, 4, 64).astype(np.int32),
             fec_idx=rng.integers(0, 2, 64).astype(np.int32))
    xr, xi = heterogeneous_fleet_iq(1, 16, 1024, seed=5)
    z.update(demod_xr=xr[0], demod_xi=xi[0])
    z.update(wb_n_ch=16, wb_steps=6, wb_wide=_air(
        {0: [1, 6, 11], 1: [3, 9, 14]}, 16, 70,
        lambda h, k: cell.CellConfig(mcc=300 + 10 * h + k,
                                     mnc=100 * h + k + 1,
                                     cc=(h * 16 + k) % 64)))
    sb_wide = _air({0: [1, 5], 1: [2, 6]}, 8, 120,
                   lambda h, k: cell.CellConfig(mcc=310 + h,
                                                mnc=50 * h + k + 1,
                                                cc=k + 1))
    adv = 1600 * 4
    wide_len = 1599 * 4 + 8 * 48
    z.update(sb_n_ch=8, sb_wide=sb_wide,
             sb_n_super=(sb_wide.shape[1] - wide_len) // (2 * adv))
    # the reference's 1x1 mesh init state, channel-major history
    state, hr, hi = pmesh.sharded_wideband_demod_init(
        pmesh.make_mesh_2d(1, 1), 8)
    z.update({"conv_" + k: np.asarray(v) for k, v in
              state._asdict().items()})
    z.update(conv_hr=np.asarray(hr), conv_hi=np.asarray(hi))
    return z


def _start(tmp) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return {(job, r): subprocess.Popen(
        [sys.executable, RANKS, job, str(r), str(n), str(tmp)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for job, n in JOBS.items() for r in range(n)}


def _wait(procs: dict, tmp) -> dict:
    """Every rank's outputs, {(job, rank): npz}; a rank that fails or
    outlives TIMEOUT fails the fixture (and its group is killed)."""
    try:
        for key, p in procs.items():
            log, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (key, log[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {(job, r): np.load(os.path.join(tmp, f"{job}_rank{r}.npz"))
            for job, r in procs}


def _sb_windows(wide, s, kw=2):
    adv, wide_len = 1600 * 4, 1599 * 4 + 8 * 48
    base = s * kw * adv
    w = np.stack([wide[..., base + j * adv:base + j * adv + wide_len]
                  for j in range(kw)], axis=-2)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _jax_refs(z) -> dict:
    """The JAX package's results on the same inputs."""
    ref = {}
    mesh_t = pmesh.make_mesh(8, "t")
    xs = jax.device_put(jnp.asarray(z["halo_x"]),
                        jax.sharding.NamedSharding(mesh_t, P(None, "t")))
    ref["halo"] = np.asarray(pmesh.halo_fir(mesh_t, z["halo_h"])(xs))
    ref["fec"] = np.asarray(jfec._decode_mixed_packed_jit(
        jnp.asarray(z["fec_t5p"]), jnp.asarray(z["fec_ks"]),
        jnp.asarray(z["fec_idx"]), jnp.asarray(z["fec_tsel"])))
    mesh = pmesh.make_mesh(8, "ch")
    sh = jax.sharding.NamedSharding(mesh, P("ch"))
    _, outs = pmesh.sharded_demod_step(mesh, 1024)(
        pmesh.sharded_demod_init(mesh, 16),
        jax.device_put(jnp.asarray(z["demod_xr"]), sh),
        jax.device_put(jnp.asarray(z["demod_xi"]), sh))
    ref["demod"] = {k: np.asarray(outs[k]) for k in ("dibits", "valid",
                                                     "sym_re", "sym_im")}
    mesh2 = pmesh.make_mesh_2d(2, 4)
    step, wide_len, adv = pmesh.sharded_wideband_demod_step(mesh2, 16)
    state = pmesh.sharded_wideband_demod_init(mesh2, 16)
    wb = {k: [] for k in ("dibits", "valid", "dist", "fleet_dist")}
    for s in range(int(z["wb_steps"])):
        blk = z["wb_wide"][:, s * adv:s * adv + wide_len]
        state, outs = step(state, jnp.asarray(blk.real.astype(np.float32)),
                           jnp.asarray(blk.imag.astype(np.float32)))
        for k in wb:
            wb[k].append(np.asarray(outs[k]))
    ref["wb"] = {k: np.stack(v) for k, v in wb.items()}
    # the 1x1 superblock from the init state, per host
    mesh1 = pmesh.make_mesh_2d(1, 1)
    step1, _, _ = pmesh.sharded_wideband_superblock_step(mesh1, 8,
                                                         t50_new=1600, kw=2)
    for h in range(2):
        st = pmesh.sharded_wideband_demod_init(mesh1, 8)
        packed, health = [], []
        for s in range(int(z["sb_n_super"])):
            wr, wi = _sb_windows(z["sb_wide"][h], s)
            st, out, hl = step1(st, jnp.asarray(wr[None]),
                                jnp.asarray(wi[None]))
            packed.append(np.asarray(out))
            health.append(np.asarray(hl))
        ref[f"sb_host{h}"] = np.stack(packed)
        ref[f"sb_host{h}_health"] = np.stack(health)
        if h == 0:
            ref["sb_end"] = st
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs and the JAX references: the rank processes run
    while the JAX programs compile and run here."""
    tmp = tmp_path_factory.mktemp("mesh")
    z = _inputs()
    np.savez(tmp / "inputs.npz", **z)
    procs = _start(tmp)
    try:
        ref = _jax_refs(z)
    finally:
        got = _wait(procs, tmp)
    return z, got, ref


def test_halo_fir_matches_unsharded_and_jax(runs):
    z, got, ref = runs
    y = np.concatenate([got["four", r]["halo_y"] for r in range(4)], axis=1)
    ext = np.concatenate([np.zeros((4, 64), np.float32), z["halo_x"]], 1)
    want = fir_valid(torch.from_numpy(ext),
                     torch.from_numpy(z["halo_h"])).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, ref["halo"], rtol=1e-5, atol=1e-5)


def test_sharded_demod_step_matches_demod_block_and_jax(runs):
    """2 ranks of 8 channels: equal to the port's unsharded demod_block
    (bits and floats alike: the chain is per channel) and, on a locked
    fleet, to the JAX sharded step's dibits and valid."""
    z, got, ref = runs
    parts = [got["two", r] for r in range(2)]
    assert [int(p["c0"]) for p in parts] == [0, 8]
    cat = {k: np.concatenate([p[k] for p in parts]) for k in
           ("dibits", "valid", "sym_re", "sym_im")}
    _, whole = TDF.demod_block(TDF.demod_init(16, "cpu"),
                               z["demod_xr"] + 1j * z["demod_xi"])
    for k, v in cat.items():
        np.testing.assert_array_equal(v, whole[k].numpy())
    v = ref["demod"]["valid"]
    np.testing.assert_array_equal(cat["valid"], v)
    np.testing.assert_array_equal(cat["dibits"][v], ref["demod"]["dibits"][v])


WB_CELLS = [1, 6, 11, 16 + 3, 16 + 9, 16 + 14]      # global channels
SB_CELLS = {0: [1, 5], 1: [2, 6]}                    # per host of 8


def test_wideband_step_2x2_matches_jax_2x4(runs):
    """The (host, chip) front end + demod on 2x2 ranks against the JAX 2x4
    mesh, column for column on the cells' channels: dibits and valid
    equal.  The all-reduced fleet_dist equals the mean over every rank's
    columns on every rank."""
    z, got, ref = runs
    cols = {}
    for r in range(4):
        g = got["four", r]
        c0 = int(g["wb_c0"])
        assert c0 == r * 8
        for k in ("dibits", "valid", "dist"):
            cols.setdefault(k, {})[c0] = g["wb_" + k]
    cat = {k: np.concatenate([v[c] for c in sorted(v)], axis=1)
           for k, v in cols.items()}
    w = ref["wb"]
    assert cat["valid"].shape == w["valid"].shape
    for c in WB_CELLS:
        v = w["valid"][:, c]
        np.testing.assert_array_equal(cat["valid"][:, c], v, err_msg=str(c))
        np.testing.assert_array_equal(cat["dibits"][:, c][v],
                                      w["dibits"][:, c][v], err_msg=str(c))
    v = cat["valid"]
    mean = [np.where(v[s], cat["dist"][s], 0.0).sum(dtype=np.float64)
            / v[s].sum() for s in range(len(v))]
    for r in range(4):
        np.testing.assert_allclose(got["four", r]["wb_fleet_dist"], mean,
                                   rtol=1e-5)


def _f32(row):
    return row.copy().view(np.float32).astype(np.float64)


def test_superblock_2x2_matches_1x1_jax_and_decodes(runs):
    """The superblock step's host-gathered words on 2x2 ranks: on the
    cells' channels rows [:-1] equal the 1x1 mesh's (host 0) and the JAX
    1x1 superblock's (each host), the mean dist the 1x1 mesh's within
    2e-3; the all-reduced health is the sum of both hosts' count and
    dist-sum rows; the port's FleetEngine decodes the gathered
    words to locked cells."""
    z, got, ref = runs
    one = got["one", 0]["sb1x1"]
    words = {}
    for h, rank in ((0, 0), (1, 2)):
        g = got["four", rank]["sb2x2"]
        words[h] = g
        want = ref[f"sb_host{h}"]
        assert g.shape == want.shape and len(g) >= 3
        for c in SB_CELLS[h]:
            np.testing.assert_array_equal(g[:, :-1, c], want[:, :-1, c])
            if h == 0:
                np.testing.assert_array_equal(g[:, :-1, c], one[:, :-1, c])
                mean = lambda a: _f32(a[:, -1, c]) / _f32(a[:, -2, c])
                np.testing.assert_allclose(mean(g), mean(one), atol=2e-3)
    total = np.stack([[_f32(words[h][s, row]).sum() for row in (-2, -1)]
                      for s in range(len(one)) for h in (0, 1)])
    total = total.reshape(len(one), 2, 2).sum(axis=1)
    for rank in (0, 2):
        np.testing.assert_allclose(got["four", rank]["sb2x2_health"], total,
                                   rtol=1e-5)
    fleet = FleetEngine(16, "cpu")
    for s in range(len(one)):
        fleet.process_packed2(np.concatenate(
            [words[0][s][:-2], words[1][s][:-2]], axis=1), 2,
            TDF.n_chunks_for(1152))
    for h, ks in SB_CELLS.items():
        for k in ks:
            assert fleet.locked(h * 8 + k), (h, k)
            assert fleet.crc_counts(h * 8 + k)[0] > 0, (h, k)


def test_mesh_state_converts_from_and_to_jax(runs):
    """The JAX sharded_wideband_demod_init state, converted by
    convert.mesh_shard_from_numpy, steps the port's 1x1 mesh to the JAX
    1x1 superblock's packed words on the cells' channels; the port's
    state after the run, converted back by mesh_shard_to_numpy, is the
    JAX state's (history and the cells' loop state, to the limits
    above).  Not held: the loops' phase accumulators (the FLL and Costas
    phases rotate the symbols by their sum, and an offset between them
    that cancels there is free to grow over a run) and the timing
    position, a fraction of a sample that the equal symbol decisions
    already pin."""
    z, got, ref = runs
    one = got["one", 0]
    for c in SB_CELLS[0]:
        np.testing.assert_array_equal(one["sb1x1"][:, :-1, c],
                                      ref["sb_host0"][:, :-1, c])
    jstate, jhr, jhi = ref["sb_end"]
    np.testing.assert_allclose(one["end_hr"], np.asarray(jhr), atol=3e-5)
    np.testing.assert_allclose(one["end_hi"], np.asarray(jhi), atol=3e-5)
    cells = SB_CELLS[0]
    for k in ("agc_gain", "fll_freq", "mm_omega", "cos_freq"):
        np.testing.assert_allclose(one["end_" + k][cells],
                                   np.asarray(getattr(jstate, k))[cells],
                                   atol=2e-4, rtol=2e-4, err_msg=k)
    np.testing.assert_array_equal(one["end_prev_sym"][cells],
                                  np.asarray(jstate.prev_sym)[cells])
    # the conversion itself round-trips exactly
    fields = {k[len("conv_"):]: v for k, v in z.items()
              if k.startswith("conv_") and k not in ("conv_hr", "conv_hi")}
    back = convert.mesh_shard_to_numpy(*convert.mesh_shard_from_numpy(
        fields, z["conv_hr"], z["conv_hi"], 2, 4, "cpu"))
    for k, v in back[0].items():
        np.testing.assert_array_equal(v, fields[k][2:6])
    np.testing.assert_array_equal(back[1], z["conv_hr"][2:6])
    np.testing.assert_array_equal(back[2], z["conv_hi"][2:6])


def test_sharded_fec_decode_matches_unsharded_and_jax(runs):
    z, got, ref = runs
    out = np.concatenate([got["four", r]["fec_out"] for r in range(4)])
    whole = tfec._decode_mixed_packed(
        *(torch.from_numpy(z[k]) for k in ("fec_t5p", "fec_ks", "fec_idx",
                                           "fec_tsel"))).numpy()
    np.testing.assert_array_equal(out, whole)
    np.testing.assert_array_equal(out, ref["fec"])
    ok = int(ref["fec"][:, -1].astype(np.int64).sum())
    assert ok > 0
    assert all(int(got["four", r]["fec_ok"]) == ok for r in range(4))


def test_nccl_refuses_ranks_sharing_a_card():
    """NCCL needs a card per rank: two ranks on one card, or a rank on the
    CPU, raise before any group starts; gloo takes both."""
    with pytest.raises(ValueError, match="nccl"):
        tmesh.check_backend("nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="nccl"):
        tmesh.check_backend("nccl", ["cpu"])
    tmesh.check_backend("gloo", ["cpu", "cpu"])


def test_multihost_launcher_selftest():
    """The launcher on the CPU: 2 hosts x 2 chips = 4 gloo ranks, one cell
    per host on carrier 3, decoded by the rank that owns it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "tetra_tpu_torch.apps.multihost", "--hosts",
         "2", "--chips", "2", "--channels", "16", "--selftest", "--device",
         "cpu", "--backend", "gloo", "--status-every", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    assert "mesh (host=2, chip=2)" in res.stdout
    for h in range(2):
        assert f"[host {h}] SELFTEST PASS" in res.stdout, res.stdout
