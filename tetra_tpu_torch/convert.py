"""The carried state between tetra_tpu (JAX) and this port.

The receiver has no learned weights: its filter tables are recomputed by
the same numpy code in both packages (tests/test_torch_tables.py holds
them bit-equal).  What carries across is the streaming state: the demod
loop state of each chain (FastDemodState, FfDemodState or DemodState, as
its _asdict() of numpy arrays, the layout of the reference's `demod_*`
checkpoint keys) and the wideband resampler history (hist_r/hist_i,
(23, C)).  The multi-host mesh's state (parallel/mesh) carries across too:
the reference keeps all channels of the mesh, host-major, with the
history channel-major, (C, 23); a rank of the port keeps its own block of
channels with the history frame-major, (23, count).
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


def mesh_shard_from_numpy(fields: dict, hist_r: np.ndarray,
                          hist_i: np.ndarray, c0: int, count: int, device):
    """The reference's mesh state (sharded_wideband_demod_init / step: the
    FastDemodState fields over all C channels and the (C, 23) resampler
    history, as numpy) -> the port rank's shard of channels c0 .. c0 +
    count - 1 (parallel/mesh.host_channels): (FastDemodState, hr (23,
    count), hi) on `device`."""
    sl = slice(c0, c0 + count)
    state = state_from_numpy({k: np.asarray(v)[sl] for k, v in
                              fields.items()}, device)
    return (state, *hist_from_numpy(np.asarray(hist_r)[sl].T,
                                    np.asarray(hist_i)[sl].T, device))


def mesh_shard_to_numpy(state, hist_r: torch.Tensor, hist_i: torch.Tensor):
    """A port rank's mesh shard -> (fields, hist_r (count, 23), hist_i),
    the reference's layout for those channels (concatenate the ranks'
    shards in channel order for the whole mesh's)."""
    return (state_to_numpy(state), hist_r.cpu().numpy().T.copy(),
            hist_i.cpu().numpy().T.copy())
