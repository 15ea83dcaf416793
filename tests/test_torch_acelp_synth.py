"""The card's ACELP synthesis (tetra_tpu_torch/csrc/acelp_synth.cu) on the
CPU: its arithmetic (csrc/acelp_synth_core.cuh) built for the host with
g++, one lane taking every lane's work in turn, driven with the wrapper's
plan() and pack_tables() and held bit for bit to voice/acelp.AcelpBank and
to the JAX package's AcelpDecoder (one a call, fed the call's items in
time order): calls of unequal lengths, halves, withheld items (a call that
opens with them, a call withheld through a batch), bad frames, the
decoders carried over three batches, in both table modes.  The kernel
itself runs on the card in tests/test_torch_cuda.py."""

import ctypes
import os

import numpy as np
import pytest

from acelp_batches import batches, random_tables
from tetra_tpu.voice import acelp as JA
from tetra_tpu_torch.ops import acelp_kernel as AK
from tetra_tpu_torch.ops._build import CSRC, host_library
from tetra_tpu_torch.voice import acelp as TA

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def emulate():
    so = host_library("acelp_synth_check",
                      [os.path.join(HERE, "acelp_synth_check.cpp"),
                       os.path.join(CSRC, "acelp_synth_core.cuh"),
                       os.path.join(CSRC, "acelp_libm.cuh")], ["-O2"])
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.acelp_synth_emulate.argtypes = [vp] * 6 + [ctypes.c_int] \
        + [vp] * 3 + [ctypes.c_int] * 2

    def run(pool, calls, frames, bfi, kind):
        order, seg, keys = AK.plan(calls)
        tables = AK.pack_tables(TA.codec_tables()[1])
        frames = np.ascontiguousarray(frames, np.uint8)
        bfi = np.ascontiguousarray(bfi, np.uint8)
        kind = np.ascontiguousarray(kind, np.int8)
        pcm = np.full((len(calls), AK.PCM), 12345, np.int16)
        rc = lib.acelp_synth_emulate(
            frames.ctypes.data, bfi.ctypes.data, kind.ctypes.data,
            order.ctypes.data, seg.ctypes.data, keys.ctypes.data, len(keys),
            pool.ctypes.data, None if tables is None else tables.ctypes.data,
            pcm.ctypes.data, AK.STATE_BYTES, AK.TABLE_BYTES)
        assert rc != -1, "State or Tables size differs from the wrapper's"
        assert rc != -2, "an adaptive-codebook chunk read its own samples"
        assert rc == 0
        return pcm
    return run


def jax_decode(decoders: dict, calls, frames, bfi, kind) -> np.ndarray:
    """The batch through the JAX package's codec, one AcelpDecoder a call
    key made on the call's first item that is not withheld: kind 0 both
    frames, kind 1 240 samples of silence then frame 2, kind 2 silence
    with the decoder left idle.  Items run in batch order, which is each
    call's time order."""
    pcm = np.zeros((len(calls), AK.PCM), np.int16)
    for i, key in enumerate(calls.tolist()):
        if kind[i] == 2:
            continue
        if key not in decoders:
            decoders[key] = JA.AcelpDecoder()
        dec = decoders[key]
        if kind[i] == 0:
            pcm[i, :240] = dec.decode_frame(frames[i, 0], bool(bfi[i, 0]))
        pcm[i, 240:] = dec.decode_frame(frames[i, 1], bool(bfi[i, 1]))
    return pcm


@pytest.mark.parametrize("tables", ["parametric", "loaded"])
@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_arithmetic_matches_host_bank(emulate, tmp_path, tables,
                                             seed):
    if tables == "loaded":
        path = tmp_path / "tables.npz"
        np.savez(path, **random_tables(seed))
        TA.load_codec_tables(str(path))
        JA.load_codec_tables(str(path))
    try:
        bank = TA.AcelpBank(threads=2)
        decoders = {}
        pool = np.zeros((1024, AK.STATE_BYTES), np.uint8)
        for calls, frames, bfi, kind in batches(seed):
            want = bank.decode(calls, frames, bfi, kind)
            ref = jax_decode(decoders, calls, frames, bfi, kind)
            got = emulate(pool, calls, frames, bfi, kind)
            assert np.array_equal(want, ref), \
                f"{int((want != ref).any(axis=1).sum())} of {len(calls)} " \
                f"items of the host bank differ from the JAX codec's"
            assert np.array_equal(got, ref), \
                f"{int((got != ref).any(axis=1).sum())} of {len(calls)} " \
                f"items differ"
            assert (want[kind == 2] == 0).all() and want.any()
        made = np.frombuffer(pool.tobytes(), np.int32).reshape(
            len(pool), -1)[:, -1]
        assert made.sum() == len(bank) == len(decoders)
    finally:
        if tables == "loaded":
            TA.clear_codec_tables()
            JA.clear_codec_tables()


def test_plan_groups_calls_in_time_order():
    calls = np.array([7, 3, 7, 900, 3, 7, 0])
    order, seg, keys = AK.plan(calls)
    assert keys.tolist() == [0, 3, 7, 900]
    assert seg.tolist() == [0, 1, 3, 6, 7]
    assert order.tolist() == [6, 1, 4, 0, 2, 5, 3]
    assert [len(a) for a in AK.plan(np.zeros(0, np.int64))] == [0, 1, 0]
    with pytest.raises(ValueError):
        AK.plan(np.array([1, -1]))


def test_codec_tables_record_loads_and_clears(tmp_path):
    """voice/acelp keeps what load_codec_tables loaded for the card's
    synthesis, and pack_tables lays it out as the kernel's Tables."""
    path = tmp_path / "tables.npz"
    t = random_tables(5)
    np.savez(path, **t)
    v0, before = TA.codec_tables()
    assert before is None
    try:
        TA.load_codec_tables(str(path))
        v1, loaded = TA.codec_tables()
        packed = AK.pack_tables(loaded).view(np.float32)
    finally:
        TA.clear_codec_tables()
    v2, after = TA.codec_tables()
    assert v0 < v1 < v2 and after is None
    assert len(packed) * 4 == AK.TABLE_BYTES
    assert np.array_equal(packed[:600].reshape(200, 3), t["lsf_cb1"])
    assert np.array_equal(packed[768:768 + 1536].reshape(512, 3),
                          t["lsf_cb2"])
    assert packed[-5] == np.float32(0.3)
    assert packed[-4:].view(np.int32).tolist() == [200, 512, 300, 50]
