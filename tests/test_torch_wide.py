"""The port at the JAX round's wide configurations, on the CPU: the front
end at 512 and 1024 channels, the demod at 1024, the fleet receiver's
sizing at (1024 carriers, wb_k 8) and (512, 16), and the fleet engine on
1024 locked channels, each against tetra_tpu on the same seeded numpy
inputs; and the card-side build of cell_air's multiplex.

Tolerances: the front end at tests/test_torch_front_end.py's atol of 3e-5
on unit-variance input, scaled by sqrt(n_ch / 16): the DFT output's RMS
grows as sqrt(n_ch) on noise, and the summation-order differences with it.
The demod: K1 as tests/test_torch_demod.py holds it; K2 and the chain
dibits and valid equal but on the channels where a loop switch explains
a parting, the floats and loop state of the others within limits set
from readings (the constants below).  The sizing and the engine's
state: equal.  Each test prints its reading."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetra_tpu.ops.demod_pallas import agc_fll_rrc as j_agc_fll_rrc
from tetra_tpu.ops.mm_pallas import mm_costas as j_mm_costas
from tetra_tpu.parallel import channelizer as JCH
from tetra_tpu.rx import demod_fast as JDF
from tetra_tpu.rx.fleet import FleetEngine as JaxEngine
from tetra_tpu.rx.receiver import TetraReceiver as JaxReceiver
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu_torch import convert
from tetra_tpu_torch.ops import demod_kernel as DK
from tetra_tpu_torch.ops import mm_kernel as MK
from tetra_tpu_torch.parallel import channelizer as TCH
from tetra_tpu_torch.rx import demod_fast as TDF
from tetra_tpu_torch.rx.fleet import FleetEngine
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.tx import wideband as TW
import chip_smoke as cs
from tests.test_torch_fleet import _assert_same_engine, _pack_words
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401

t = torch.from_numpy
PAD = TCH.RS_TAPS_PER_PHASE - 1
FRONT_ATOL_16 = 3e-5          # tests/test_torch_front_end.py at n_ch = 16
DEMOD_REL = 2e-4              # tests/test_torch_demod.py, two blocks
K1_MF_ATOL = 2e-4             # K1's mf, absolute (signal ~ the AGC setpoint)
# the demod at 1024 channels (test_demod_matches_jax_at_1024), on
# heterogeneous_fleet_iq(2, 1024, 4608, seed=DEMOD_SEED).  Readings over
# seeds 5-8, 2 blocks each (PYTHONPATH=. python3
# tests/torch_wide_readings.py --cpu-demod --seeds 5 6 7 8): channels
# parted in the chain 9-15 of 1024 a block, every one explained (a loop
# switch: a symbol within max(K2_AXIS_EPS, its drift) of an axis, or
# the Costas leak's threshold); their drift before the parting up to
# 0.039; on the other channels the floats within FLOAT_CLOSE
# (chip_smoke's TOL_K2_CLOSE) on 0.99952-1 of the slots, all within
# 9.4e-3, and the loop state within 1.09e-2.  The limits are twice the
# largest reading; FLOAT_SHARE is 0.999, under the least share read.
DEMOD_SEED = 5
MAX_PARTED = 30               # channels of 1024, a block
FLOAT_CLOSE, FLOAT_SHARE, FLOAT_MAX = 1e-3, 0.999, 0.02
DRIFT_MAX = 0.08
STATE_MAX = 0.022


@pytest.mark.parametrize("n_ch", [512, 1024])
def test_front_end_matches_xla_at_width(n_ch):
    """Two streamed blocks, t50 = 800 then a 775 tail: the second takes
    the first's resampler history (the reference's XLA composition, as
    tests/test_torch_front_end.py runs it)."""
    rng = np.random.default_rng(n_ch)
    hop = n_ch // 2
    atol = FRONT_ATOL_16 * np.sqrt(n_ch / 16)
    hj = (jnp.zeros((PAD, n_ch), jnp.float32),) * 2
    ht = (torch.zeros(PAD, n_ch), torch.zeros(PAD, n_ch))
    err = 0.0
    for t50 in (800, 775):
        t36 = t50 * 18 // 25
        wide_len = (t50 - 1) * hop + n_ch * TCH.TAPS_PER_BRANCH
        xr = rng.standard_normal(wide_len).astype(np.float32)
        xi = rng.standard_normal(wide_len).astype(np.float32)
        ref = JCH._front_end_block(jnp.asarray(xr), jnp.asarray(xi), *hj,
                                   n_ch, t36, use_pallas=False)
        got = TCH._front_end_block(t(xr), t(xi), *ht, n_ch, t36)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            e = float(np.abs(g.numpy() - np.asarray(r)).max())
            assert e <= atol, (t50, e, atol)
            err = max(err, e)
        hj, ht = ref[2:], got[2:]
    print(f"front end n_ch={n_ch}: max abs err {err:.3g} (atol {atol:.3g})")


@pytest.fixture(scope="module")
def wide_fleet_iq():
    """(2, 1024, 4608) heterogeneous locked-fleet blocks, re and im."""
    return TW.heterogeneous_fleet_iq(2, 1024, 4608, seed=DEMOD_SEED)


def _parted(got: dict, ref: dict) -> np.ndarray:
    """Per channel (last axis), whether two demod outputs part: valid
    differs, or a dibit on a valid slot."""
    v = ref["valid"].astype(bool)
    return ((got["valid"] != ref["valid"])
            | ((got["dibits"] != ref["dibits"]) & v)).any(axis=0)


def _partings(k2, traced: tuple) -> dict:
    """Where the K2 output k2 (sym_re, sym_im, dibits, valid, dist) parts
    from mm_costas_plain's traced run on the same input (traced, from
    chip_smoke.k2_plain_traced), valid or a dibit on a valid slot: per
    channel its first parting slot, the least axis distance and leak gap
    of the plain run from K2_LEAK_LOOKBACK groups before it up to it
    (chip_smoke.first_switch), the drift (the largest |sym - plain| /
    |plain| on the slots before it), and whether a loop switch explains
    the parting: k2_check's rule (a symbol within K2_AXIS_EPS of an axis,
    or |cfreq| within K2_LEAK_EPS of the leak threshold), the axis
    distance also within the drift (the two runs' symbols that far apart
    can lie on either side of an axis that near)."""
    p2, ax, gap, G = traced
    k2 = [torch.from_numpy(np.array(o)) for o in k2[:4]]
    vk, vp = k2[3].bool(), p2[3].bool()
    out = cs.first_switch((vk != vp) | ((k2[2] != p2[2]) & vp), ax, gap, G)
    drift = torch.where(vk & vp, torch.hypot(k2[0] - p2[0], k2[1] - p2[1])
                        / torch.hypot(p2[0], p2[1]).clamp_min(1e-12), 0.0)
    for c, v in out.items():
        v["drift"] = float(drift[:v["slot"], c].max()) if v["slot"] else 0.0
        v["explained"] = bool(
            v["axis"] <= max(cs.K2_AXIS_EPS, v["drift"])
            or v["leak_gap"] <= cs.K2_LEAK_EPS)
    return out


def _float_err(got: dict, ref: dict, parted) -> tuple[float, float]:
    """The floats (sym_re, sym_im, dist; those present) on the slots the
    reference calls valid, on the channels not in parted: the largest
    error and the share within FLOAT_CLOSE."""
    keep = np.ones(ref["valid"].shape[-1], bool)
    keep[list(parted)] = False
    v = ref["valid"].astype(bool)[:, keep]
    err = np.concatenate([np.abs(got[k][:, keep] - ref[k][:, keep])[v]
                          for k in ("sym_re", "sym_im", "dist") if k in ref])
    return float(err.max()), float((err <= FLOAT_CLOSE).mean())


def demod_readings(xr: np.ndarray, xi: np.ndarray) -> list[dict]:
    """The demod's stages on the streamed blocks xr/xi ((n, C, T)) from
    the port's carried state, against the reference: K1's plain version
    against the reference's Pallas kernel (interpret mode) on the same
    input; K2 (full form) in both on the reference K1's output, each
    parting channel with its explanation (_partings); the port's K2 on
    its own K1 output against it on the reference's, the same way (how
    K1's last-bit differences carry into K2); then the lean chain (tc_out)
    in both from the same state.  Returns per block the errors, the parted
    channels and their explanations (nothing is asserted here)."""
    C, T = xr.shape[1], xr.shape[2]
    n_chunks = TDF.n_chunks_for(T)
    st = TDF.demod_init(C, "cpu")
    readings = []
    for b in range(len(xr)):
        x_r, x_i = xr[b].T.copy(), xi[b].T.copy()
        h = (st.fll_hist_re.T.numpy().copy(), st.fll_hist_im.T.numpy().copy())
        s1 = (st.agc_gain.numpy(), st.fll_phase.numpy(), st.fll_freq.numpy())
        ref1 = [np.asarray(o).copy() for o in j_agc_fll_rrc(
            *map(jnp.asarray, (x_r, x_i, *s1, *h)), interpret=True)]
        got1 = [o.numpy() for o in DK.agc_fll_rrc(
            *map(t, (x_r, x_i, *s1, *h)))]
        k1_state = max(float((np.abs(got1[k] - ref1[k][0]) / np.maximum(
            1.0, np.abs(ref1[k][0]))).max()) for k in (2, 3, 4))
        zero = torch.zeros(C)
        st0 = torch.stack([st.mm_pos, st.mm_omega, st.cos_phase,
                           st.cos_freq, st.cos_ph2,
                           st.prev_sym.to(torch.float32), zero, zero])
        kw = dict(tail_re=st.mm_tail_re.T.contiguous(),
                  tail_im=st.mm_tail_im.T.contiguous())
        args2 = (t(ref1[0]), t(ref1[1]), st0, n_chunks)
        ref2 = j_mm_costas(
            jnp.asarray(ref1[0]), jnp.asarray(ref1[1]),
            jnp.asarray(st0.numpy()), n_chunks, interpret=True,
            **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
        traced = cs.k2_plain_traced(args2, dict(kw, emit_syms=True),
                                    n_chunks)
        k2 = _partings(ref2, traced)
        inp = _partings(MK.mm_costas(t(got1[0]), t(got1[1]), st0, n_chunks,
                                     **kw), traced)
        names = ("sym_re", "sym_im", "dibits", "valid", "dist")
        k2_float = _float_err(
            dict(zip(names, (o.numpy() for o in traced[0]))),
            dict(zip(names, map(np.asarray, ref2))), sorted(k2))
        # the lean chain, the reference from the port's state
        js = JDF.FastDemodState(**{k: jnp.asarray(v) for k, v in
                                   convert.state_to_numpy(st).items()})
        with JDF.pallas_interpret():
            js, jo = JDF._demod_block_impl(js, jnp.asarray(xr[b]),
                                           jnp.asarray(xi[b]), n_chunks,
                                           True, True, tc_out=True)
        st, to = TDF._demod_block_impl(st, t(xr[b]), t(xi[b]), n_chunks,
                                       tc_out=True)
        keys = ("valid", "dibits", "dist")
        ref = {k: np.asarray(jo[f"{k}_tc"]) for k in keys}
        got = {k: to[f"{k}_tc"].numpy() for k in keys}
        parted = _parted(got, ref)
        chain_float = _float_err(got, ref, np.nonzero(parted)[0])
        state_err = np.zeros(C)
        for k, a in convert.state_to_numpy(st).items():
            # channels on the first axis; the symbol position is rounded
            # at ~T before T is subtracted (tests/test_torch_demod.py)
            r = np.asarray(getattr(js, k)).astype(np.float64)
            e = (np.abs(a - r) / np.maximum(1.0, np.abs(r))).reshape(C, -1)
            e -= float(np.spacing(np.float32(T))) * (k == "mm_pos")
            state_err = np.maximum(state_err, e.max(axis=1))
        readings.append(dict(
            block=b, valid_share=float(ref["valid"].mean()),
            k1_mf_err=max(float(np.abs(got1[k] - ref1[k]).max())
                          for k in (0, 1)),
            k1_state_err=k1_state,
            k2_partings=k2, k2_float_err=k2_float[0],
            k2_float_close=k2_float[1],
            k2_unexplained=[c for c, v in k2.items() if not v["explained"]],
            k1_into_k2_partings=inp,
            k1_into_k2_unexplained=[c for c, v in inp.items()
                                    if not v["explained"]],
            chain_parted=np.nonzero(parted)[0].tolist(),
            chain_float_err=chain_float[0], chain_float_close=chain_float[1],
            state_err=float(state_err[~parted].max())))
    return readings


def test_demod_matches_jax_at_1024(wide_fleet_iq):
    """The demod at 1024 channels, two streamed blocks (demod_readings).

    At this width the 8-channel tests' equality does not hold: on a few
    channels a block the two part where a loop switches on a last-bit
    difference (a symbol at an axis, where sgn() picks the quadrant and
    the Costas error, or the Costas leak's threshold), and the Costas
    phase drifts apart ~1e-5 a group (tests/test_torch_demod.py), 72
    groups a block.  So: K1 within K1_MF_ATOL and DEMOD_REL; in K2 on
    the same input and in K1's carry into K2, every parting explained by
    a loop switch (_partings), its drift before it within DRIFT_MAX; the
    chain's partings no others than those (equal dibits and valid on
    every other channel), at most MAX_PARTED of them; on the other
    channels the floats within FLOAT_CLOSE on FLOAT_SHARE of the slots
    and all within FLOAT_MAX, the loop state within STATE_MAX."""
    xr, xi = wide_fleet_iq
    readings = demod_readings(xr, xi)
    print(f"demod C={xr.shape[1]}: {readings}")
    for r in readings:
        assert r["valid_share"] > 0.4
        assert r["k1_mf_err"] <= K1_MF_ATOL, r
        assert r["k1_state_err"] <= DEMOD_REL, r
        assert not r["k2_unexplained"], r
        assert not r["k1_into_k2_unexplained"], r
        assert set(r["chain_parted"]) <= set(r["k2_partings"]) | set(
            r["k1_into_k2_partings"]), r
        for v in (*r["k2_partings"].values(),
                  *r["k1_into_k2_partings"].values()):
            assert v["drift"] <= DRIFT_MAX, r
        assert len(r["chain_parted"]) <= MAX_PARTED, r
        for what in ("k2", "chain"):
            assert r[f"{what}_float_close"] >= FLOAT_SHARE, r
            assert r[f"{what}_float_err"] <= FLOAT_MAX, r
        assert r["state_err"] <= STATE_MAX, r


@pytest.mark.parametrize("profile", ["tunnel", "pcie"])
@pytest.mark.parametrize("carriers, wb_k", [(1024, 8), (512, 16)])
def test_fleet_sizing_matches_jax_at_width(carriers, wb_k, profile):
    """The row capacity of a superblock call (tetra_tpu/rx/fleet.py), and
    the link profile passed to the engine."""
    kw = dict(wideband=carriers, t50=6400, wb_k=wb_k, fleet=True,
              link_profile=profile)
    got = TetraReceiver(device="cpu", **kw)
    ref = JaxReceiver(events=False, **kw)
    g, r = got.fleet, ref.fleet
    assert g.link_profile == r.link_profile == profile
    n_chunks = got._wb["n_chunks"]
    for f in (g, r):
        f._ensure_rowbufs(wb_k, n_chunks * 2 * 16)
    assert g._cap == r._cap and g._t5.shape == r._t5.shape
    print(f"sizing {carriers} x wb_k {wb_k} {profile}: cap {g._cap}")


ENGINE_CH, ENGINE_CELLS = 1024, 8
ENGINE_CHUNKS, ENGINE_K, ENGINE_CALLS = 75, 2, 2


def _engine_words():
    """Superblock words of ENGINE_CH locked channels: carrier c carries
    cell c % 8 (MCC 262, MNC 100 + i) from a narrowband stream, started
    c // 8 symbols in (before the first SYNC burst), every symbol
    valid."""
    T = ENGINE_CHUNKS * 32
    n = ENGINE_CALLS * ENGINE_K * T
    shift = ENGINE_CH // ENGINE_CELLS
    streams = []
    for i in range(ENGINE_CELLS):
        bits, _ = cell.downlink_bits(
            cell.CellConfig(mcc=262, mnc=100 + i, cc=1 + i),
            2 * (n + shift) // 255 + 4, start=TdmaTime(mn=1, fn=17, tn=4))
        streams.append(((bits[0::2] << 1) | bits[1::2]).astype(np.uint8))
    dibm = np.stack([streams[c % ENGINE_CELLS][c // ENGINE_CELLS:][:n]
                     for c in range(ENGINE_CH)])
    valid = np.ones_like(dibm, bool)
    per = ENGINE_K * T
    return [_pack_words(dibm[:, s * per:(s + 1) * per],
                        valid[:, s * per:(s + 1) * per], ENGINE_K,
                        ENGINE_CHUNKS) for s in range(ENGINE_CALLS)]


def test_fleet_engine_matches_jax_at_1024():
    """FleetEngine.process_packed2 in both packages on the same superblock
    words of 1024 locked channels: burst sync, CRC tallies, cell and
    display equal on every channel (and the whole state blob)."""
    words = _engine_words()
    ours = FleetEngine(ENGINE_CH, "cpu")
    ref = JaxEngine(ENGINE_CH)
    for w in words:
        assert ours.process_packed2(w, ENGINE_K, ENGINE_CHUNKS) \
            == ref.process_packed2(w, ENGINE_K, ENGINE_CHUNKS)
    _assert_same_engine(ours, ref, ENGINE_CH)
    locked = sum(ours.locked(c) for c in range(ENGINE_CH))
    oks = sum(ours.crc_counts(c)[0] for c in range(ENGINE_CH))
    fails = sum(ours.crc_counts(c)[1] for c in range(ENGINE_CH))
    own = sum(ours.display(c).mnc == 100 + c % ENGINE_CELLS
              for c in range(ENGINE_CH))
    assert locked == own == ENGINE_CH and oks > 0 and fails == 0
    print(f"engine {ENGINE_CH} ch: equal; locked {locked}, own cell {own}, "
          f"crc {oks} ok / {fails} failed")


def test_cell_air_device_carriers_at_unit_power():
    """cell_air_device (16 carriers, 0.5 s, device="cpu"): about `seconds`
    of air at 16 x 25 kHz, and in each carrier's 25 kHz channel its unit
    power plus the floor 25 dB under it."""
    n_ch, seconds, fs = 16, 0.5, 16 * 25_000
    x = TW.cell_air_device(n_ch, seconds, device="cpu").numpy()
    assert x.dtype == np.complex64 and 0.99 * seconds * fs <= len(x) \
        <= seconds * fs
    X = np.abs(np.fft.fft(x)) ** 2 / len(x) ** 2
    f = np.fft.fftfreq(len(x), 1 / fs)
    power = [float(X[np.abs((f - c * 25_000 + fs / 2) % fs - fs / 2)
                     < 12_500].sum()) for c in range(n_ch)]
    want = 1 + 10 ** -2.5
    assert np.allclose(power, want, atol=5e-3), power
    print(f"card-side air: channel powers {min(power):.5f}-"
          f"{max(power):.5f} (unit + floor {want:.5f})")


def test_cell_air_device_decodes_every_carrier():
    """cell_air_device's air (32 carriers, ~2 s, device="cpu") through the
    port's fleet receiver: every carrier locked on its own cell."""
    n_ch = 32
    wide = TW.cell_air_device(n_ch, 2.0, device="cpu")
    assert wide.dtype == torch.complex64
    rx = TetraReceiver(wideband=n_ch, t50=6400, fleet=True, wb_k=4,
                       device="cpu")
    rx.process_wideband(wide.numpy())
    rx.flush_wideband()
    own = [c for c in range(n_ch) if rx.locked(c)
           and (rx.display(c).mcc, rx.display(c).mnc) == (262, 100 + c % 8)]
    oks = sum(rx.crc_counts(c)[0] for c in range(n_ch))
    fails = sum(rx.crc_counts(c)[1] for c in range(n_ch))
    assert len(own) == n_ch and oks > 3 * fails
    print(f"card-side air, {n_ch} carriers: {len(own)} locked on their own "
          f"cell, crc {oks} ok / {fails} failed")


def test_staged_windows_of_device_air_match_host():
    """staged_windows cuts air held as a tensor into the same superblocks
    as the host array, and from a given superblock on."""
    air = TW.cell_air_device(16, 0.7, device="cpu")
    adv, wl = 6400 * 8, 6399 * 8 + 16 * TCH.TAPS_PER_BRANCH
    host = TW.staged_windows(air.numpy(), adv, wl, 2, "cpu")
    dev = TW.staged_windows(air, adv, wl, 2, "cpu")
    tail = TW.staged_windows(air, adv, wl, 2, "cpu", first=1, count=1)
    assert len(host) == len(dev) >= 2 and len(tail) == 1
    for a, b in zip(host + host[1:2], dev + tail):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == torch.float32
            assert torch.equal(x, y)
