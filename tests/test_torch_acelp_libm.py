"""The card's ACELP synthesis computes the codec's cosf and expf with
replicas of glibc's algorithms (tetra_tpu_torch/csrc/acelp_libm.cuh).
Built here for the host with g++, beside the host's own libm called as
the codec calls it (std::cos and std::exp of a float): bit for bit on an
even stride of the floats of the codec's ranges (cos of the LSFs in
[0, 3.2], exp of the clamped log gain in [0, 9]), the negatives, the
thresholds of each algorithm's branches and its quadrant edges, large
arguments and the special values."""

import ctypes
import os

import numpy as np
import pytest

from tetra_tpu_torch.ops._build import CSRC, host_library

HERE = os.path.dirname(os.path.abspath(__file__))
STRIDE = 251                    # prime: no lock-step with the mantissa


@pytest.fixture(scope="module")
def pairs():
    so = host_library("acelp_libm_check",
                      [os.path.join(HERE, "acelp_libm_check.cpp"),
                       os.path.join(CSRC, "acelp_libm.cuh")], ["-O2"])
    lib = ctypes.CDLL(so)
    lib.libm_pairs.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_void_p]

    def run(fn: int, x: np.ndarray):
        x = np.ascontiguousarray(x, np.float32)
        rep, host = np.empty_like(x), np.empty_like(x)
        lib.libm_pairs(fn, x.ctypes.data, len(x), rep.ctypes.data,
                       host.ctypes.data)
        return rep, host
    return run


def _bits(v: float) -> int:
    return int(np.float32(v).view(np.uint32))


def _strided(lo: float, hi: float) -> np.ndarray:
    """Every STRIDE-th float of [lo, hi] (0 <= lo < hi), hi included."""
    b = np.arange(_bits(lo), _bits(hi) + 1, STRIDE, dtype=np.uint64)
    b = np.append(b, _bits(hi)).astype(np.uint32)
    return b.view(np.float32)


def _around(centres, ulps: int = 4096) -> np.ndarray:
    """The 2 ulps + 1 floats around each positive centre."""
    b = np.concatenate([np.arange(_bits(c) - ulps, _bits(c) + ulps + 1,
                                  dtype=np.int64) for c in centres])
    return b.astype(np.uint32).view(np.float32)


def _assert_same(rep: np.ndarray, host: np.ndarray, x: np.ndarray) -> None:
    same = (rep.view(np.uint32) == host.view(np.uint32)) \
        | (np.isnan(rep) & np.isnan(host))
    bad = np.nonzero(~same)[0]
    assert not len(bad), (
        f"{len(bad)} of {len(x)} differ, first at x = {x[bad[0]]!r}: "
        f"{rep[bad[0]]!r} against the host's {host[bad[0]]!r}")


_COS_EDGES = [np.pi / 4, 0.75, 2.0 ** -12, np.pi / 2, 3 * np.pi / 4, np.pi,
              5 * np.pi / 4, 3 * np.pi / 2, 120.0]
_EXP_EDGES = [2.0 ** -20, 1.0, np.log(2) / 64, np.log(2) / 32, 8.0, 9.0,
              88.0, 88.72]


@pytest.mark.parametrize("case", ["range", "negative", "edges", "large"])
def test_cosf_replica_matches_host(pairs, case):
    if case == "range":
        x = _strided(0.0, 3.2)
        assert len(x) >= 2 ** 22
    elif case == "negative":
        x = -_strided(0.0, 3.2)
    elif case == "edges":
        x = _around(_COS_EDGES)
        x = np.concatenate([x, -x])
    else:
        x = np.concatenate([_strided(120.0, 3.4e38)[::16],
                            np.float32([np.inf, -np.inf, np.nan, 0.0,
                                        -0.0])])
        x = np.concatenate([x, -x])
    _assert_same(*pairs(0, x), x)


@pytest.mark.parametrize("case", ["range", "edges", "special"])
def test_expf_replica_matches_host(pairs, case):
    if case == "range":
        x = _strided(0.0, 9.0)
        assert len(x) >= 2 ** 22
    elif case == "edges":
        x = _around(_EXP_EDGES)
        x = np.concatenate([x, -x])
    else:
        x = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 88.8, 89.0,
                        -104.0, -103.5, 1e30, -1e30])
    _assert_same(*pairs(1, x), x)
