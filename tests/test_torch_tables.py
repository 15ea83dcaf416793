"""Every table the port computes (filters, interpolator polynomials, band
matrices, channelizer prototype and DFT basis, resampler matrices, trellis,
CRC and RM tables) is bit-equal to the JAX reference's, and so are the
loop constants."""

import numpy as np
import pytest

from tetra_tpu.ops import chan_pallas as CP
from tetra_tpu.ops import demod_pallas as DP
from tetra_tpu.parallel import channelizer as JCH
from tetra_tpu.rx import demod as JD
from tetra_tpu.rx import demod_fast as JDF
from tetra_tpu.rx import fec as JFEC
from tetra_tpu.rx import viterbi as JV
from tetra_tpu.ops import train_corr as JTC
from tetra_tpu_torch.ops import chan_kernel as CK
from tetra_tpu_torch.ops import train_corr as TTC
from tetra_tpu_torch.ops import demod_kernel as DK
from tetra_tpu_torch.parallel import channelizer as TCH
from tetra_tpu_torch.rx import demod as TD
from tetra_tpu_torch.rx import demod_fast as TDF
from tetra_tpu_torch.rx import fec as TFEC
from tetra_tpu_torch.rx import viterbi as TV


def _port_band_stack():
    """The reference kernel's stacked band matrix, from the port's tables."""
    _, be, _ = TD._tables()
    rrc = TD._tables()[0]
    offs = TDF._fll_tap_offsets(TDF.K_SAMP)
    mats = TDF._band_matrices(list(be) + [np.asarray(rrc, np.float32)])
    return np.concatenate([m[:, offs].T for m in mats[:4]] + [mats[4].T])


TABLES = {
    "rrc": (lambda: TD._tables()[0], lambda: JD._tables()[0]),
    "band_edge": (lambda: np.stack(TD._tables()[1]),
                  lambda: np.stack(JD._tables()[1])),
    "interp_bank": (lambda: TD._tables()[2], lambda: JD._tables()[2]),
    "bank_polys": (lambda: np.stack(TDF._bank_polys()),
                   lambda: np.stack(JDF._bank_polys())),
    "fll_tap_offsets": (lambda: TDF._fll_tap_offsets(64),
                        lambda: JDF._fll_tap_offsets(64)),
    "band_stack": (_port_band_stack, lambda: DP._band_stack(False)),
    "k1_taps": (lambda: DK._host_tables()[0],
                lambda: np.concatenate([np.stack(JD._tables()[1]),
                                        JD._tables()[0][None]])),
    "prototype_256": (lambda: TCH._prototype(256),
                      lambda: JCH._prototype(256)),
    "prototype_16": (lambda: TCH._prototype(16), lambda: JCH._prototype(16)),
    "dft_basis_256": (lambda: np.stack(TCH._dft_basis(256)),
                      lambda: np.stack(JCH._dft_basis(256))),
    "fold_weights": (lambda: CK._fold_weights(TCH._prototype(256), 256),
                     lambda: CP._fold_weights(JCH._prototype(256), 256)),
    "resamp_bank": (lambda: TCH._resamp_bank(18, 25),
                    lambda: JCH._resamp_bank(18, 25)),
    "resamp_matrix": (lambda: TCH._resamp_matrix(18, 25)[0],
                      lambda: JCH._resamp_matrix(18, 25)[0]),
    "resamp_super_matrix": (lambda: TCH._resamp_super_matrix(18, 25, 32),
                            lambda: JCH._resamp_super_matrix(18, 25, 32)),
    "trellis_cch": (lambda: TV._CCH_TABLES[0], lambda: JV._CCH_TABLES[0]),
    "trellis_tch": (lambda: TV._TCH_TABLES[0], lambda: JV._TCH_TABLES[0]),
    "acs_cch": (lambda: np.stack(TV._acs_tables(False)),
                lambda: np.stack(JV._acs_tables(False))),
    "crc_matrix_140": (lambda: TFEC._crc_matrix(140)[0],
                       lambda: JFEC._crc_matrix(140)[0]),
    "rm_codebook": (lambda: TFEC._rm_codebook_pm1(),
                    lambda: JFEC._rm_codebook_pm1()),
    "deinterleave_216": (lambda: TFEC._deinterleave_idx(216, 101),
                         lambda: JFEC._deinterleave_idx(216, 101)),
    "train_seq_kernels": (
        lambda: np.concatenate([k for _, _, k in TTC._seq_kernels()]),
        lambda: np.concatenate([k for _, _, k in JTC._seq_kernels()])),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_bit_equal(name):
    port, ref = TABLES[name]
    a, b = np.asarray(port()), np.asarray(ref())
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_resample_taps_are_the_matrix_band():
    """The resample kernel's compact (18, 24) taps + offsets reproduce the
    banded matrix the plain resampler multiplies by."""
    W, B, ZF = TCH._resamp_matrix(18, 25)
    coef, off = CK._resamp_taps()
    W2 = np.zeros_like(W)
    for p in range(18):
        W2[ZF + off[p]:ZF + off[p] + 24, p] = coef[p]
    np.testing.assert_array_equal(W2, W)


CONSTS = ("K_SAMP", "K_SYM", "FLL_DECIM", "_FLL_BETA", "_COSTAS_ALPHA",
          "_COSTAS_BETA", "_MM_MU_GAIN", "_MM_OMEGA_GAIN",
          "_COSTAS_FREQ_LIM_CHUNKED", "_PAIR_MU", "_PAIR_OM", "_PAIR_CA",
          "_PAIR_CB", "_PAIR_CLIM", "_OMEGA_MIN", "_OMEGA_MAX")


@pytest.mark.parametrize("name", CONSTS)
def test_loop_constant_equal(name):
    assert getattr(TDF, name) == getattr(JDF, name)


@pytest.mark.parametrize("T", [512, 1024, 4608])
def test_n_chunks_for_equal(T):
    assert TDF.n_chunks_for(T) == JDF.n_chunks_for(T)


# the per-sample chain's (rx/demod.py) and the feedforward chain's
# (rx/demod_ff.py) constants
EXACT_CONSTS = ("_FLL_ALPHA", "_FLL_BETA", "_COSTAS_ALPHA", "_COSTAS_BETA",
                "_MM_MU_GAIN", "_MM_OMEGA_GAIN", "_OMEGA", "_OMEGA_MIN",
                "_OMEGA_MAX", "_FLL_FREQ_LIM", "_COSTAS_FREQ_LIM",
                "_DIFF_REMAP")


@pytest.mark.parametrize("name", EXACT_CONSTS)
def test_exact_chain_constant_equal(name):
    _same(getattr(TD, name), getattr(JD, name))


@pytest.mark.parametrize("T", [1024, 4096, 4608])
def test_exact_max_symbols_and_ff_segment_equal(T):
    from tetra_tpu.rx import demod_ff as JFF
    from tetra_tpu_torch.rx import demod_ff as TFF
    assert TD.max_symbols(T) == JD.max_symbols(T)
    assert TFF.SEG_SYM == JFF.SEG_SYM


# ---------------------------------------------------------------------------
# The port's copies of host-only modules (it imports nothing of tetra_tpu):
# each copy is held to its original here.

import ctypes
import os

from tetra_tpu import params as JP
from tetra_tpu.core import taps as JTAPS
from tetra_tpu.rx import display as JDISP
from tetra_tpu.rx import native_mac as JNM
from tetra_tpu.rx.tdma import TdmaTime as JTdmaTime
from tetra_tpu.tx import burst as JBURST
from tetra_tpu.tx import cell as JCELL
from tetra_tpu.tx import fec_enc as JFEC_ENC
from tetra_tpu_torch import params as TP
from tetra_tpu_torch.core import taps as TTAPS
from tetra_tpu_torch.rx import display as TDISP
from tetra_tpu_torch.rx import fleet as TFLEET
from tetra_tpu_torch.rx import native_mac as TNM
from tetra_tpu_torch.rx.tdma import TdmaTime as TTdmaTime
from tetra_tpu_torch.tx import burst as TBURST
from tetra_tpu_torch.tx import cell as TCELL
from tetra_tpu_torch.tx import fec_enc as TFEC_ENC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    """Deep equality of constants: arrays exactly, containers item by
    item, functions (the puncturers' index maps) on their domain."""
    if callable(a):
        assert callable(b)
        for j in range(1, 600):
            assert a(j) == b(j), j
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


PARAM_NAMES = sorted(n for n in vars(JP) if n.isupper())


def test_params_names_equal():
    assert PARAM_NAMES == sorted(n for n in vars(TP) if n.isupper())


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_params_constant_equal(name):
    _same(getattr(TP, name), getattr(JP, name))


@pytest.mark.parametrize("fn", ["scramb_get_init", "puncture_indices",
                                "interleave_indices"])
def test_params_function_equal(fn):
    args = {"scramb_get_init": [(262, 1234, 7), (901, 16383, 63)],
            "puncture_indices": [(p, 432) for p in range(7)],
            "interleave_indices": [(216, 101), (120, 11), (432, 103)]}[fn]
    for a in args:
        _same(np.asarray(getattr(TP, fn)(*a)),
              np.asarray(getattr(JP, fn)(*a)))


TAPS = {
    "rrc_65": lambda m: m.root_raised_cosine(65, 0.35, 1.0, 2.0),
    "rrc_33": lambda m: m.root_raised_cosine(33, 0.25, 18000.0, 36000.0),
    "nuttall": lambda m: m.nuttall(np.arange(1024), 1024),
    "band_edge": lambda m: np.stack(m.band_edge_pair(65, 0.35, 1.0, 2.0)),
    "interp_bank": lambda m: m.interp_bank(),
}


@pytest.mark.parametrize("name", sorted(TAPS))
def test_taps_copy_equal(name):
    _same(np.asarray(TAPS[name](TTAPS)), np.asarray(TAPS[name](JTAPS)))


def _fec_burst_cases():
    rng = np.random.default_rng(11)
    t1 = {bt: rng.integers(0, 2, JP.BLK_PARAMS[bt][3]).astype(np.uint8)
          for bt in JP.BLK_PARAMS}
    sb = lambda m: m.build_sync_burst(
        *(rng_bits(m, bt) for bt in (JP.TPSAP_T_SB1, JP.TPSAP_T_BBK,
                                     JP.TPSAP_T_SB2)))

    def rng_bits(m, bt):
        enc = TFEC_ENC if m is TBURST else JFEC_ENC
        return enc.encode_block(t1[bt], bt, 0x1234567)

    return {
        "crc16": lambda m: np.asarray(m.crc16_bits(t1[JP.TPSAP_T_NDB])),
        "conv_encode": lambda m: m.conv_encode(t1[JP.TPSAP_T_SB2]),
        "scramb_keystream": lambda m: m.scramb_keystream(0x2468ACE, 432),
        "rm3014": lambda m: m.rm3014_encode(t1[JP.TPSAP_T_BBK]),
        **{f"encode_block_{bt}": (lambda m, bt=bt: m.encode_block(
            t1[bt], bt, 0x1234567)) for bt in JP.BLK_PARAMS},
        "sync_burst": sb,
        "norm_burst": lambda m: m.build_norm_burst(
            rng_bits(m, JP.TPSAP_T_NDB), rng_bits(m, JP.TPSAP_T_BBK),
            rng_bits(m, JP.TPSAP_T_NDB), two_log_chan=True),
    }


FEC_BURST = _fec_burst_cases()


@pytest.mark.parametrize("name", sorted(FEC_BURST))
def test_fec_enc_and_burst_copy_equal(name):
    fn = FEC_BURST[name]
    port = TBURST if name.endswith("burst") else TFEC_ENC
    ref = JBURST if name.endswith("burst") else JFEC_ENC
    _same(np.asarray(fn(port)), np.asarray(fn(ref)))


def _cell_crypto(state_mod, cfg):
    """A TEA1 cipher state for the cell, built in one package."""
    ks = state_mod.KeyStore()
    ks.nets.append(state_mod.NetInfo(cfg["mcc"], cfg["mnc"], ksg_type=1,
                                     security_class=2))
    ks.keys.append(state_mod.Key(cfg["mcc"], cfg["mnc"], addr=0,
                                 key_type=state_mod.KEYTYPE_CCK_SCK,
                                 key_num=3, key=bytes(range(10)),
                                 network=ks.nets[0]))
    cs = state_mod.CryptoState(store=ks)
    cs.cc, cs.la, cs.cn, cs.hn, cs.cck_id = cfg["cc"], 21, 3600, 42, 3
    cs.update_network(cfg["mcc"], cfg["mnc"])
    return cs


DOWNLINK_CASES = ["signalling", "frag", "voice", "stolen", "crypto",
                  "voice_stolen_crypto"]


@pytest.mark.parametrize("case", DOWNLINK_CASES)
def test_downlink_bits_copy_equal(case):
    """A seeded cell through each arm of downlink_bits (signalling only, a
    fragmented SDU, voice on two timeslots, stolen slots of both kinds, a
    TEA1-encrypted cell, and all of these together): bits and records."""
    from tetra_tpu.crypto import state as JST
    from tetra_tpu_torch.crypto import state as TST
    cfg = dict(mcc=262, mnc=105, cc=6)

    def kw(pkg):
        out = {}
        if case == "frag":
            msg = np.random.default_rng(5).integers(0, 2, 260).astype(
                np.uint8)
            out["frag_message"] = ((3, 2), msg)
        if "voice" in case or "stolen" in case:
            rng = np.random.default_rng(9)
            frames = lambda: rng.integers(0, 2, (2, 137)).astype(np.uint8)
            out["voice_slots"] = {2: frames, 3: frames}
        if "stolen" in case:
            out["stolen_slots"] = {(4, 2): "both", (6, 3): "first",
                                   (9, 2): "first", (12, 3): "both"}
        if "crypto" in case:
            out["crypto"] = _cell_crypto(TST if pkg == "port" else JST,
                                         cfg)
        return out

    tb, trec = TCELL.downlink_bits(
        TCELL.CellConfig(**cfg), 300, start=TTdmaTime(mn=2, fn=1, tn=1),
        payload_rng=np.random.default_rng(3), **kw("port"))
    jb, jrec = JCELL.downlink_bits(
        JCELL.CellConfig(**cfg), 300, start=JTdmaTime(mn=2, fn=1, tn=1),
        payload_rng=np.random.default_rng(3), **kw("jax"))
    _same(tb, jb)
    assert [(r.kind, vars(r.time)) for r in trec] == \
        [(r.kind, vars(r.time)) for r in jrec]
    kinds = {r.kind for r in trec}
    assert kinds >= {"sync", "ndb"}
    assert ("frag_start" in kinds) == (case == "frag")
    assert ("voice" in kinds) == (case != "signalling" and case != "frag"
                                  and case != "crypto")
    assert ("stch" in kinds) == ("stolen" in case)
    for a, b in zip(trec, jrec):
        _same(a.type1, b.type1)


def test_display_state_fields_equal():
    t, j = TDISP.DisplayState(), JDISP.DisplayState()
    assert t.as_dict() == j.as_dict()
    assert list(t.as_dict()) == list(j.as_dict())


def _layout(struct):
    out = []
    for name, typ in struct._fields_:
        sub = _layout(typ) if hasattr(typ, "_fields_") else typ.__name__
        out.append((name, getattr(struct, name).offset, ctypes.sizeof(typ),
                    sub))
    return out


@pytest.mark.parametrize("name", ["MacStateStruct", "AachStruct",
                                  "SysinfoStruct"])
def test_mac_state_struct_layout_equal(name):
    t, j = getattr(TNM, name), getattr(JNM, name)
    assert ctypes.sizeof(t) == ctypes.sizeof(j)
    assert _layout(t) == _layout(j)


@pytest.mark.parametrize("src", ["fleet.cpp", "macparse.cpp",
                                 "acelp_codec.cpp", "iq_stream.cpp"])
def test_native_source_copy_byte_equal(src):
    """The fleet engine, the native MAC core, the ACELP codec and the IQ
    stream runtime build from the port's own copies of the C++ sources,
    which stay byte-equal to the JAX package's."""
    port = os.path.join(TFLEET._NATIVE, src)
    assert os.path.commonpath([port, os.path.join(ROOT, "tetra_tpu_torch")]) \
        == os.path.join(ROOT, "tetra_tpu_torch")
    ref_dir = {"acelp_codec.cpp": ("voice", "native"),
               "iq_stream.cpp": ("runtime", "native")}.get(src,
                                                           ("rx", "native"))
    with open(port, "rb") as a, open(os.path.join(
            ROOT, "tetra_tpu", *ref_dir, src), "rb") as b:
        assert a.read() == b.read()


def test_iq_stream_builds_from_the_port_copy():
    from tetra_tpu_torch.runtime import iq_stream
    assert iq_stream._SRC == os.path.join(TFLEET._NATIVE, "iq_stream.cpp")


# ---------------------------------------------------------------------------
# The host copies of the per-channel receiver's bit pipeline.

from tetra_tpu.rx import burst_sync as JBS
from tetra_tpu.rx import llc as JLLC
from tetra_tpu.rx import mac_pdu as JMAC
from tetra_tpu.rx import mle as JMLE
from tetra_tpu.rx import upper_mac as JUM
from tetra_tpu_torch.rx import burst_sync as TBS
from tetra_tpu_torch.rx import llc as TLLC
from tetra_tpu_torch.rx import mac_pdu as TMAC
from tetra_tpu_torch.rx import mle as TMLE
from tetra_tpu_torch.rx import upper_mac as TUM

HOST_COPIES = {"mac_pdu": (TMAC, JMAC), "llc": (TLLC, JLLC),
               "mle": (TMLE, JMLE), "upper_mac": (TUM, JUM),
               "burst_sync": (TBS, JBS), "native_mac": (TNM, JNM)}


def _constant_names(mod):
    """Module-level upper-case names bound to data (not modules, classes,
    functions, or the native module's paths and lazily loaded handles)."""
    skip = {"_NATIVE_MAC_MOD", "_DIR", "_SRC", "_SO"}
    return sorted(n for n, v in vars(mod).items()
                  if n.lstrip("_")[:1].isupper() and n.upper() == n
                  and n not in skip and not callable(v)
                  and type(v).__name__ != "module")


HOST_CONSTS = [(m, n) for m, (_, j) in sorted(HOST_COPIES.items())
               for n in _constant_names(j)]


@pytest.mark.parametrize("module,name", HOST_CONSTS)
def test_host_copy_constant_equal(module, name):
    port, ref = HOST_COPIES[module]
    _same(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("module", sorted(HOST_COPIES))
def test_host_copy_names_and_dataclasses_equal(module):
    """The same constants, and every dataclass with the same fields and
    defaults."""
    import dataclasses
    port, ref = HOST_COPIES[module]
    assert _constant_names(port) == _constant_names(ref)
    for n, v in vars(ref).items():
        if dataclasses.is_dataclass(v) and v.__module__ == ref.__name__:
            fields = lambda cls: [
                (f.name, repr(f.default)) for f in dataclasses.fields(cls)]
            assert fields(getattr(port, n)) == fields(v), n


@pytest.mark.parametrize("module", ["mac_pdu", "llc", "mle", "modulator2"])
def test_host_parser_copy_byte_equal(module):
    """The PDU parsers and the clean-room modulator (tx/modulator2.py,
    NumPy only) are verbatim copies."""
    if module == "modulator2":
        from tetra_tpu.tx import modulator2 as ref
        from tetra_tpu_torch.tx import modulator2 as port
    else:
        port, ref = HOST_COPIES[module]
    with open(port.__file__, "rb") as a, open(ref.__file__, "rb") as b:
        assert a.read() == b.read()
