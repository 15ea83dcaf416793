"""The port's jax-free TX fixtures equal the originals they copy
(tetra_tpu.tx.wideband.synthesize_wideband and bench.heterogeneous_fleet_iq),
cell_air keeps its synthesis length 7-smooth, and every kernel wrapper
refuses a device that is neither the CPU nor CUDA instead of picking one."""

import numpy as np
import pytest
import torch

import bench
from tetra_tpu.rx.tdma import TdmaTime
from tetra_tpu.tx import cell
from tetra_tpu.tx.wideband import synthesize_wideband as j_synthesize
from tetra_tpu_torch.ops import chan_kernel as CK
from tetra_tpu_torch.ops import demod_kernel as DK
from tetra_tpu_torch.ops import mm_kernel as MK
from tetra_tpu_torch.tx import wideband as TW


@pytest.mark.parametrize("cfo, snr", [(0.0, None), (150.0, 20.0)])
def test_synthesize_wideband_equals_reference(cfo, snr):
    streams = [cell.downlink_bits(cell.CellConfig(mnc=100 + i), 12,
                                  start=TdmaTime(mn=2, fn=14, tn=1))[0]
               for i in range(2)]
    L = min(len(s) for s in streams)
    bitmat = np.stack([streams[c % 2][:L] for c in range(4)])
    cfo_hz = cfo * np.arange(1, 5)
    a = TW.synthesize_wideband(bitmat, 4, cfo_hz=cfo_hz, snr_db=snr, seed=9)
    b = j_synthesize(bitmat, 4, cfo_hz=cfo_hz, snr_db=snr, seed=9)
    assert a.dtype == b.dtype == np.complex64
    np.testing.assert_array_equal(a, b)


def test_heterogeneous_fleet_iq_equals_bench():
    a = TW.heterogeneous_fleet_iq(2, 3, 512, seed=4)
    b = bench.heterogeneous_fleet_iq(2, 3, 512, seed=4)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_cell_air_length_is_7_smooth():
    wide = TW.cell_air(4, 0.2, n_cells=2)
    t50 = len(wide) // 2                      # T50 * channels/2 samples
    assert len(wide) == 2 * t50 and t50 % 25 == 0
    assert TW._largest_prime_factor(t50) <= 7
    assert wide.dtype == np.complex64 and np.isfinite(wide).all()


_META = dict(device="meta", dtype=torch.float32)

_CALLS = {
    "agc_fll_rrc": lambda: DK.agc_fll_rrc(
        *(torch.empty(64, 4, **_META),) * 2,
        *(torch.empty(4, **_META),) * 3,
        *(torch.empty(64, 4, **_META),) * 2),
    "mm_costas": lambda: MK.mm_costas(
        *(torch.empty(64, 4, **_META),) * 2, torch.empty(8, 4, **_META), 2,
        tail_re=torch.empty(7, 4, **_META),
        tail_im=torch.empty(7, 4, **_META)),
    "fold_dft": lambda: CK.fold_dft(*(torch.empty(100, 4, **_META),) * 2, 8),
    "fold_dft_resample": lambda: CK.fold_dft_resample(
        *(torch.empty(100, 4, **_META),) * 2,
        *(torch.empty(23, 8, **_META),) * 2, 8, 4),
    "resample": lambda: CK.resample(
        *(torch.empty(25, 8, **_META),) * 2,
        *(torch.empty(23, 8, **_META),) * 2, 18),
}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_wrappers_refuse_other_devices(name):
    with pytest.raises(ValueError, match="unsupported device"):
        _CALLS[name]()
