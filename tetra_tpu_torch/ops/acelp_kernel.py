"""The voice monitor's ACELP synthesis on the card (csrc/acelp_synth.cu):
a batch of every call's codec frames to 8 kHz PCM in one kernel launch,
each call's decoder state kept on the card between batches.

AcelpCardBank has voice/acelp.AcelpBank's decode, bit for bit: the kernel
is the host codec's decoder (csrc/host/acelp_codec.cpp) written for one
warp a call, with glibc's cosf and expf (csrc/acelp_libm.cuh).  Its plain
twin is the host codec itself, which the monitor runs on CPU devices; the
CPU tests build the kernel's arithmetic (csrc/acelp_synth_core.cuh) for
the host and hold it to the codec with this module's plan() and
pack_tables().
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spans as S
from ..voice import acelp
from . import _build

FRAME_BITS = 137
PCM = 480                       # samples an item
STATE_BYTES = 1764              # sizeof(acelp_synth::State)
TABLE_WORDS = 256 * 3 + 512 * 3 + 512 * 4 + 64 * 2 + 5
TABLE_BYTES = 4 * TABLE_WORDS   # sizeof(acelp_synth::Tables)


def plan(calls: np.ndarray):
    """voice/acelp.plan_calls in int32, the kernel's index type: (order,
    seg, keys), call c's items order[seg[c]:seg[c + 1]] on decoder
    keys[c].  Keys must lie in [0, 2^31)."""
    calls = np.asarray(calls, np.int64)
    if len(calls) and (calls.min() < 0 or calls.max() >= 2 ** 31):
        raise ValueError("AcelpCardBank: call keys must lie in [0, 2^31)")
    return tuple(a.astype(np.int32) for a in acelp.plan_calls(calls))


def pack_tables(tables) -> np.ndarray | None:
    """The codec's runtime tables (voice/acelp.codec_tables()'s second
    item) as the kernel's Tables struct, TABLE_BYTES of uint8; None for
    the parametric quantizers."""
    if tables is None:
        return None
    cb1, cb2, cb3, gcb, pred = tables
    t = np.zeros(TABLE_WORDS, np.float32)
    at = 0
    for arr, rows, w in ((cb1, 256, 3), (cb2, 512, 3), (cb3, 512, 4),
                         (gcb, 64, 2)):
        t[at:at + arr.size] = np.asarray(arr, np.float32).reshape(-1)
        at += rows * w
    t[at] = pred
    t[at + 1:].view(np.int32)[:] = [len(cb1), len(cb2), len(cb3), len(gcb)]
    return t.view(np.uint8)


def synth(frames: torch.Tensor, bfi: torch.Tensor, kind: torch.Tensor,
          order: torch.Tensor, seg: torch.Tensor, keys: torch.Tensor,
          pool: torch.Tensor, tables: torch.Tensor | None,
          pcm: torch.Tensor) -> None:
    """One launch on the current stream: the items of every call of the
    batch (plan()'s order, seg and keys, int32) through their decoders in
    pool ((cap, STATE_BYTES) uint8, every key < cap), frames (N, 2, 137)
    and bfi (N, 2) uint8, kind (N,) int8, into pcm (N, 480) int16; tables
    (TABLE_BYTES,) uint8 or None.  All on one CUDA device, contiguous."""
    n, k = frames.shape[0], keys.shape[0]
    dev = pool.device
    for name, t, dtype, shape in (
            ("frames", frames, torch.uint8, (n, 2, FRAME_BITS)),
            ("bfi", bfi, torch.uint8, (n, 2)),
            ("kind", kind, torch.int8, (n,)),
            ("order", order, torch.int32, (n,)),
            ("seg", seg, torch.int32, (k + 1,)),
            ("keys", keys, torch.int32, (k,)),
            ("pcm", pcm, torch.int16, (n, PCM)),
            ("tables", tables, torch.uint8, (TABLE_BYTES,)),
            ("pool", pool, torch.uint8, (pool.shape[0], STATE_BYTES))):
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda" or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"acelp synth: {name} must be contiguous "
                             f"{dtype} {shape} on a CUDA device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    err = _build.load().launch_acelp_synth(
        frames.data_ptr(), bfi.data_ptr(), kind.data_ptr(),
        order.data_ptr(), seg.data_ptr(), keys.data_ptr(), k,
        pool.data_ptr(), 0 if tables is None else tables.data_ptr(),
        pcm.data_ptr(), STATE_BYTES, TABLE_BYTES, _build.stream_of(pool))
    _build.check(err, "acelp_synth")
    synth.launches += 1


synth.launches = 0              # ACELP synthesis kernel launches


class AcelpCardBank:
    """AcelpBank's decoders on a CUDA device: one decoder state a call key
    in a pool on the card (made on the call's first synthesised item,
    kept for the bank's life, grown as keys come), a batch in one upload,
    one synth() launch and one fetch into a pinned buffer, copied out.
    The codec's runtime tables are read from voice/acelp at each batch."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"AcelpCardBank: needs a CUDA device, got "
                             f"{self.device}")
        self._pool = torch.zeros((0, STATE_BYTES), dtype=torch.uint8,
                                 device=self.device)
        self._tables_version = None
        self._tables = None
        self._stage = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self._dev_in = torch.empty(0, dtype=torch.uint8, device=self.device)
        self._fetch = torch.empty((0, PCM), dtype=torch.int16,
                                  pin_memory=True)

    def _grow(self, cap: int) -> None:
        pool = torch.zeros((cap, STATE_BYTES), dtype=torch.uint8,
                           device=self.device)
        pool[:len(self._pool)] = self._pool
        self._pool = pool

    def _table_tensor(self):
        version, tables = acelp.codec_tables()
        if version != self._tables_version:
            packed = pack_tables(tables)
            self._tables = None if packed is None else \
                torch.from_numpy(packed).to(self.device)
            self._tables_version = version
        return self._tables

    def decode(self, calls: np.ndarray, frames: np.ndarray, bfi: np.ndarray,
               kind: np.ndarray) -> np.ndarray:
        """AcelpBank.decode on the card: items in time order within each
        call, calls (N,) int64 keys >= 0, frames (N, 2, 137) uint8 bits,
        bfi (N, 2) flags, kind (N,) 0 a full slot, 1 a surviving second
        half, 2 withheld.  Returns (N, 480) int16 PCM, fetched once into
        pinned memory and handed out in an array of its own.
        Counts the items synthesised (not withheld) in voice.acelp_rows."""
        n = len(calls)
        if n == 0:
            return np.empty((0, PCM), np.int16)
        order, seg, keys = plan(calls)
        kind = np.ascontiguousarray(kind, np.int8)
        assert np.shape(frames) == (n, 2, FRAME_BITS) \
            and np.shape(bfi) == (n, 2) and kind.shape == (n,)
        if keys[-1] >= len(self._pool):
            self._grow(max(int(keys[-1]) + 1, 2 * len(self._pool)))
        # one staging buffer, each part at a multiple of 4 bytes
        parts = ((np.asarray(frames, np.uint8), torch.uint8),
                 (np.asarray(bfi, np.uint8), torch.uint8),
                 (kind, torch.int8), (order, torch.int32),
                 (seg, torch.int32), (keys, torch.int32))
        at, places = 0, []
        for arr, dtype in parts:
            places.append((at, arr.nbytes, dtype, arr.shape))
            at = (at + arr.nbytes + 3) & ~3
        if len(self._stage) < at:
            self._stage = torch.empty(2 * at, dtype=torch.uint8,
                                      pin_memory=True)
            self._dev_in = torch.empty(2 * at, dtype=torch.uint8,
                                       device=self.device)
        stage = self._stage.numpy()
        for (arr, _), (lo, nb, _, _) in zip(parts, places):
            stage[lo:lo + nb] = np.ascontiguousarray(arr).reshape(-1).view(
                np.uint8)
        self._dev_in[:at].copy_(self._stage[:at], non_blocking=True)
        args = [self._dev_in[lo:lo + nb].view(dtype).view(shape)
                for lo, nb, dtype, shape in places]
        pcm = torch.empty((n, PCM), dtype=torch.int16, device=self.device)
        synth(*args, self._pool, self._table_tensor(), pcm)
        if len(self._fetch) < n:
            self._fetch = torch.empty((2 * n, PCM), dtype=torch.int16,
                                      pin_memory=True)
        self._fetch[:n].copy_(pcm, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        S.count("voice.acelp_rows", int((kind != 2).sum()))
        # out of the pinned buffer into an array of the caller's own, on
        # torch's CPU threads (its fresh pages fault in parallel)
        out = torch.empty((n, PCM), dtype=torch.int16)
        out.copy_(self._fetch[:n])
        return out.numpy()
