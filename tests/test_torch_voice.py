"""The port's voice path (voice/channel, voice/pipeline, voice/acelp)
against tetra_tpu's on the same seeded inputs: the speech channel decode
and encode under every codec profile of the calibrator's search space, the
profile calibrator, the voice pipeline's audio and the ACELP codec.  Bits,
bad-frame flags, profiles and PCM must be equal.  The port decodes on the
CPU (device="cpu").

Each package keeps its process-global codec profile; a test that sets one
sets the other too and restores both."""

import itertools
import json

import numpy as np
import pytest
import torch

from tetra_tpu.rx.tdma import TdmaTime as JTdmaTime
from tetra_tpu.voice import acelp as JA
from tetra_tpu.voice import channel as JV
from tetra_tpu.voice import pipeline as JP
from tetra_tpu_torch.ops import _build
from tetra_tpu_torch.rx.tdma import TdmaTime as TTdmaTime
from tetra_tpu_torch.voice import acelp as TA
from tetra_tpu_torch.voice import channel as TV
from tetra_tpu_torch.voice import pipeline as TP
from tests.test_torch_receiver_channel import one_torch_thread  # noqa: F401
from tests.test_voice import _vowel

# the calibrator's search space: both 5.5.3 conventions, all six
# multiplex orders, two CRC generator pairs; and the default profile
PROFILES = {"default": {}}
for transposed, mux, (crc8, crc4) in itertools.product(
        (False, True), JV.ProfileCalibrator.MUX_SHORTLIST,
        ((0x1D, 0x3), (0x07, 0x9))):
    PROFILES[f"t{int(transposed)}-{mux}-{crc8:#04x}"] = dict(
        il_transposed=transposed, mux_order=mux, crc8_poly=crc8,
        crc4_poly=crc4)


def _profiles(name):
    kw = PROFILES[name]
    if not kw:
        return None, None
    return (JV.CodecProfile(name=name, **kw),
            TV.CodecProfile(name=name, **kw))


def _slot_cases(rng, B: int, encode, n_bits: int) -> dict:
    """Clean encoded slots, the same with 5 bit errors each, and random
    bits (the class-2 CRC fails)."""
    clean = np.stack([encode(rng) for _ in range(B)])
    errors = clean.copy()
    for row in errors:
        row[rng.choice(n_bits, 5, replace=False)] ^= 1
    heavy = rng.integers(0, 2, (B, n_bits)).astype(np.uint8)
    return {"clean": clean, "errors": errors, "heavy": heavy}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decode_matches_jax(name):
    """decode_slot and decode_half_slot: equal frames and bfi for B = 1
    and 8 on clean, lightly and heavily corrupted slots."""
    jp, tp = _profiles(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    full = lambda r: JV.encode_slot(
        r.integers(0, 2, 274).astype(np.uint8), profile=jp)
    half = lambda r: JV.encode_half_slot(
        r.integers(0, 2, 137).astype(np.uint8), profile=jp)
    for B in (1, 8):
        for (jdec, tdec, enc, n) in ((JV.decode_slot, TV.decode_slot, full,
                                      432),
                                     (JV.decode_half_slot,
                                      TV.decode_half_slot, half, 216)):
            for case, x in _slot_cases(rng, B, enc, n).items():
                jf, jb = jdec(x, profile=jp)
                tf, tb = tdec(x, profile=tp, device="cpu")
                assert tf.dtype == jf.dtype and tf.shape == jf.shape
                assert tb.dtype == jb.dtype
                np.testing.assert_array_equal(tf, jf, err_msg=(B, case))
                np.testing.assert_array_equal(tb, jb, err_msg=(B, case))
                if case == "clean":
                    assert not tb.any()
                if case == "heavy" and B == 8:
                    assert tb.sum() >= 6


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_matches_jax(name):
    """encode_slot and encode_half_slot give equal type-3 bits, and the
    port's decode inverts them."""
    jp, tp = _profiles(name)
    rng = np.random.default_rng(7 + len(name))
    frames = rng.integers(0, 2, (3, 2, 137)).astype(np.uint8)
    for f in frames:
        a = TV.encode_slot(f.reshape(-1), profile=tp)
        np.testing.assert_array_equal(a, JV.encode_slot(f.reshape(-1),
                                                        profile=jp))
        h = TV.encode_half_slot(f[0], profile=tp)
        np.testing.assert_array_equal(h, JV.encode_half_slot(f[0],
                                                             profile=jp))
        got, bfi = TV.decode_slot(a, profile=tp, device="cpu")
        assert not bfi[0] and (got[0] == f).all()


def test_host_tables_and_helpers_equal():
    """The reorder tables, interleave/mux perms, CRCs and reorderings are
    the reference's."""
    for n in ("_CLASS0_POS", "_CLASS1_POS", "_CLASS2_POS"):
        np.testing.assert_array_equal(getattr(TV, n), getattr(JV, n))
    for lines in (24, 12):
        sizes = JV._FULL_SIZES if lines == 24 else JV._HALF_SIZES
        for transposed, order in itertools.product(
                (False, True), JV.ProfileCalibrator.MUX_SHORTLIST):
            for a, b in zip(TV._mux_perm_pair(lines, 18, transposed, order,
                                              sizes),
                            JV._mux_perm_pair(lines, 18, transposed, order,
                                              sizes)):
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 274).astype(np.uint8)
    np.testing.assert_array_equal(TV.reorder_to_codec(bits),
                                  JV.reorder_to_codec(bits))
    np.testing.assert_array_equal(TV.reorder_from_codec(bits),
                                  JV.reorder_from_codec(bits))
    for poly in (None, 0x07, 0x31):
        np.testing.assert_array_equal(TV.crc8_bits(bits[:60], poly),
                                      JV.crc8_bits(bits[:60], poly))
    for poly in (None, 0x9, 0xB):
        np.testing.assert_array_equal(TV.crc4_bits(bits[:30], poly),
                                      JV.crc4_bits(bits[:30], poly))
    type3 = rng.integers(0, 2, 432).astype(np.uint8)
    np.testing.assert_array_equal(TV.interleave(type3), JV.interleave(type3))
    assert (TV.CodecProfile(), TV.ProfileCalibrator.CRC8_SHORTLIST,
            TV.ProfileCalibrator.CRC4_SHORTLIST) == (
        TV.CodecProfile(**vars(JV.CodecProfile())),
        JV.ProfileCalibrator.CRC8_SHORTLIST,
        JV.ProfileCalibrator.CRC4_SHORTLIST)


def _feed(vp, slots, kind: str, Time):
    """Feed slots to a pipeline, one TDMA frame each, on timeslot 2."""
    for i, s in enumerate(slots):
        t = Time(mn=3 + i // 18, fn=(i % 18) + 1, tn=2, sn=1)
        (vp.half if kind == "half" else vp)(t, s)


CALIBRATION = {
    # alternate full-slot convention: CRC-8 0x07, transposed matrix, mux 210
    "full": ("full", dict(crc8_poly=0x07, il_transposed=True,
                          mux_order="210")),
    # alternate CRC-4 generator for stolen halves
    "half": ("half", dict(crc4_poly=0x9)),
    # a CRC-8 generator outside the shortlist: the search exhausts
    "exhausted": ("full", dict(crc8_poly=0xD5)),
}


@pytest.mark.parametrize("case", sorted(CALIBRATION))
def test_calibrator_resolves_the_same_profile(case):
    """VoicePipeline(calibrate=True) of both packages on one stream sent
    under another convention: the same resolved profile, log, status,
    counters and audio; the process-global profiles stay untouched."""
    kind, kw = CALIBRATION[case]
    alt = JV.CodecProfile(name="alt-tx", **kw)
    rng = np.random.default_rng(5)
    if kind == "full":
        frames = rng.integers(0, 2, (14, 274)).astype(np.uint8)
        slots = [JV.encode_slot(f, profile=alt) for f in frames]
    else:
        frames = rng.integers(0, 2, (12, 137)).astype(np.uint8)
        slots = [JV.encode_half_slot(f, profile=alt) for f in frames]
    j0, t0 = JV.get_profile(), TV.get_profile()
    jvp = JP.VoicePipeline(calibrate=True)
    tvp = TP.VoicePipeline(calibrate=True, device="cpu")
    assert tvp.calibrator.device == torch.device("cpu")
    jlog, tlog = [], []
    jvp.calibrator.log, tvp.calibrator.log = jlog.append, tlog.append
    _feed(jvp, slots, kind, JTdmaTime)
    _feed(tvp, slots, kind, TTdmaTime)
    assert tlog == jlog and tlog
    assert tvp.calibration_status() == jvp.calibration_status()
    for attr in ("resolved", "resolved_half"):
        a, b = getattr(tvp.calibrator, attr), getattr(jvp.calibrator, attr)
        assert (a is None) == (b is None)
        if a is not None:
            assert vars(a) == vars(b)
    assert (tvp.slots_decoded, tvp.bad_frames) == (jvp.slots_decoded,
                                                   jvp.bad_frames)
    np.testing.assert_array_equal(tvp.take_audio(), jvp.take_audio())
    if case == "exhausted":
        assert tvp.calibration_status()["full"] == "exhausted"
    else:
        assert tvp.profile is not None and vars(tvp.profile) == vars(
            jvp.profile)
    assert JV.get_profile() is j0 and TV.get_profile() is t0


@pytest.mark.parametrize("kind", ["full", "half"])
def test_pipeline_audio_matches_jax(kind):
    """The full-slot and stolen-half flows of VoicePipeline: clean,
    errored and garbage slots, and a second traffic slot in one TDMA frame
    (the active-timeslot gate drops it): equal audio and counters."""
    rng = np.random.default_rng(17 if kind == "full" else 18)
    enc = ((lambda r: JV.encode_slot(r.integers(0, 2, 274).astype(
        np.uint8))) if kind == "full" else
        (lambda r: JV.encode_half_slot(r.integers(0, 2, 137).astype(
            np.uint8))))
    cases = _slot_cases(rng, 4, enc, 432 if kind == "full" else 216)
    slots = np.concatenate([cases["clean"], cases["errors"],
                            cases["heavy"]])
    jvp, tvp = JP.VoicePipeline(), TP.VoicePipeline(device="cpu")
    for vp, Time in ((jvp, JTdmaTime), (tvp, TTdmaTime)):
        _feed(vp, slots, kind, Time)
        call = vp.half if kind == "half" else vp
        call(Time(mn=9, fn=4, tn=2, sn=1), slots[0])
        call(Time(mn=9, fn=4, tn=3, sn=1), slots[1])      # gated out
    assert (tvp.slots_decoded, tvp.bad_frames) == (jvp.slots_decoded,
                                                   jvp.bad_frames)
    assert tvp.slots_decoded == len(slots) + 1 and 0 < tvp.bad_frames
    audio = tvp.take_audio()
    assert audio.dtype == np.int16 and len(audio) == 480 * tvp.slots_decoded
    np.testing.assert_array_equal(audio, jvp.take_audio())
    assert len(tvp.take_audio()) == 0


def test_load_profile_matches_jax(tmp_path):
    """load_profile makes the same profile active in each package, and the
    default-profile decode follows it."""
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(dict(crc8_poly="0x31", crc4_poly=9,
                                    il_transposed=True, mux_order="021",
                                    name="loaded")))
    j0, t0 = JV.get_profile(), TV.get_profile()
    try:
        jp, tp = JV.load_profile(str(path)), TV.load_profile(str(path))
        assert vars(tp) == vars(jp) and TV.get_profile() is tp
        rng = np.random.default_rng(2)
        slots = np.stack([JV.encode_slot(rng.integers(0, 2, 274).astype(
            np.uint8)) for _ in range(3)])
        jf, jb = JV.decode_slot(slots)
        tf, tb = TV.decode_slot(slots, device="cpu")
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tb, jb)
        assert not tb.any()
    finally:
        JV.set_profile(j0)
        TV.set_profile(t0)


def test_acelp_decoder_matches_jax():
    """Random frames with a bad-frame pattern, through each package's
    decoder frame by frame and slot by slot: equal PCM."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 2, (60, 137)).astype(np.uint8)
    bfi = rng.random(60) < 0.1
    jd, td = JA.AcelpDecoder(), TA.AcelpDecoder()
    for f, b in zip(frames, bfi):
        np.testing.assert_array_equal(td.decode_frame(f, bfi=bool(b)),
                                      jd.decode_frame(f, bfi=bool(b)))
    for k in range(0, 60, 2):
        np.testing.assert_array_equal(
            td.decode_slot(frames[k:k + 2], bfi=bool(bfi[k])),
            jd.decode_slot(frames[k:k + 2], bfi=bool(bfi[k])))
    assert (TA.FRAME_LAYOUT, TA.FRAME_BITS, TA.FRAME_SAMPLES,
            TA.SAMPLE_RATE) == (JA.FRAME_LAYOUT, JA.FRAME_BITS,
                                JA.FRAME_SAMPLES, JA.SAMPLE_RATE)
    assert [TA.frame_field(n) for n, _, _ in TA.FRAME_LAYOUT] == \
        [JA.frame_field(n) for n, _, _ in JA.FRAME_LAYOUT]


def test_acelp_encoder_matches_jax():
    """Synthetic voiced speech through each package's encoder: equal
    frames, slot by slot, and equal PCM back through the decoders."""
    pcm = _vowel(dur_s=0.48)
    je, te = JA.AcelpEncoder(), TA.AcelpEncoder()
    jd, td = JA.AcelpDecoder(), TA.AcelpDecoder()
    for s in range(len(pcm) // 480):
        block = pcm[s * 480:(s + 1) * 480]
        f = te.encode_slot(block)
        np.testing.assert_array_equal(f, je.encode_slot(block))
        np.testing.assert_array_equal(td.decode_slot(f), jd.decode_slot(f))


def test_codec_tables_match_jax(tmp_path):
    """Runtime quantizer tables loaded into both codecs: equal frames and
    PCM under them, and both revert on clear."""
    rng = np.random.default_rng(7)
    means = np.array([0.24, 0.47, 0.81, 1.12, 1.44, 1.78, 2.09, 2.40,
                      2.68, 2.94], np.float32)
    path = tmp_path / "tables.npz"
    np.savez(path,
             lsf_cb1=(means[:3] + rng.normal(0, 0.08, (256, 3))).astype(
                 np.float32),
             lsf_cb2=(means[3:6] + rng.normal(0, 0.08, (512, 3))).astype(
                 np.float32),
             lsf_cb3=(means[6:] + rng.normal(0, 0.08, (512, 4))).astype(
                 np.float32),
             gain_cb=np.stack([rng.uniform(0, 1.2, 64),
                               np.exp(rng.uniform(2.0, 7.0, 64))],
                              1).astype(np.float32),
             lsf_pred=np.float32(0.25))
    pcm = _vowel(dur_s=0.24)
    try:
        JA.load_codec_tables(str(path))
        TA.load_codec_tables(str(path))
        assert TA._load().tetra_acelp_tables_loaded() == 1
        je, te = JA.AcelpEncoder(), TA.AcelpEncoder()
        jd, td = JA.AcelpDecoder(), TA.AcelpDecoder()
        for k in range(len(pcm) // 240):
            f = te.encode_frame(pcm[k * 240:(k + 1) * 240])
            np.testing.assert_array_equal(
                f, je.encode_frame(pcm[k * 240:(k + 1) * 240]))
            np.testing.assert_array_equal(td.decode_frame(f),
                                          jd.decode_frame(f))
    finally:
        JA.clear_codec_tables()
        TA.clear_codec_tables()
    assert TA._load().tetra_acelp_tables_loaded() == 0


def test_acelp_library_is_the_ports_own_build():
    """The codec is built from tetra_tpu_torch/csrc/host/acelp_codec.cpp
    into the build directory, never loaded from the JAX package."""
    lib = TA._load()
    assert TA._SRC == f"{_build._PKG}/csrc/host/acelp_codec.cpp"
    assert lib._name.startswith(_build.BUILD_DIR + "/libtetra_acelp_")


def test_voice_entry_points_need_cuda_unless_asked_for_the_cpu():
    """With no device= the speech decode, the pipeline and the calibrator
    run on the current CUDA device; without CUDA they raise rather than
    fall back to the CPU."""
    slot = np.zeros((1, 432), np.uint8)
    if torch.cuda.is_available():
        assert TP.VoicePipeline().device.type == "cuda"
        return
    for make in (lambda: TV.decode_slot(slot),
                 lambda: TV.decode_half_slot(slot[:, :216]),
                 lambda: TP.VoicePipeline(),
                 lambda: TV.ProfileCalibrator()):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            make()
