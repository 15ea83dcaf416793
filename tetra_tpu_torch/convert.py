"""The carried state between tetra_tpu (JAX) and this port.

The receiver has no learned weights: its filter tables are recomputed by
the same numpy code in both packages (tests/test_torch_tables.py holds
them bit-equal).  What carries across is the streaming state: the demod
loop state of each chain (FastDemodState, FfDemodState or DemodState, as
its _asdict() of numpy arrays, the layout of the reference's `demod_*`
checkpoint keys) and the wideband resampler history (hist_r/hist_i,
(23, C)).
"""

from __future__ import annotations

import numpy as np
import torch

from .rx.demod_fast import FastDemodState

_INT_FIELDS = ("prev_sym", "mm_offset")      # int32; every other is float32


def state_from_numpy(fields: dict, device, cls=FastDemodState):
    """cls._asdict() of numpy arrays (either package) -> the port's state
    of type cls (FastDemodState, FfDemodState or DemodState) on
    `device`."""
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__} lacks {sorted(missing)}")
    return cls(**{k: torch.from_numpy(np.array(
        fields[k], dtype=np.int32 if k in _INT_FIELDS else np.float32)).to(
            device) for k in cls._fields})


def state_to_numpy(state) -> dict:
    """The port's state -> {field: numpy array}, the reference's layout."""
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def hist_from_numpy(hist_r: np.ndarray, hist_i: np.ndarray, device):
    """Wideband resampler history (23, C) pair -> device tensors."""
    to = lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device)
    return to(hist_r), to(hist_i)


def hist_to_numpy(hist_r: torch.Tensor, hist_i: torch.Tensor):
    return hist_r.cpu().numpy(), hist_i.cpu().numpy()
