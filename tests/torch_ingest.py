"""Helpers for the fleet receiver's host-ingest tests (no jax): one air as
cf32 and as cs16 with equal values, the irregular chunks it is fed in,
and a spy on the windows and packed words of every superblock a receiver
runs.

The cs16 feed is the cf32 air quantized to int16: the card converts each
int16 to float32 and scales it by 2**-15, which gives the cf32 feed's
float32 exactly, so the two feeds must decode bit for bit alike."""

from __future__ import annotations

import numpy as np
import torch

PRIME = 104729              # the 10,000th prime


def quantized(wide: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cf32, cs16): complex64 air at half full scale and the same values
    as interleaved int16 I/Q."""
    q = np.round(wide * (0.5 / np.abs(wide).max()) * 32767)
    cs16 = np.stack([q.real, q.imag], axis=1).reshape(-1).astype(np.int16)
    return (q / 32768.0).astype(np.complex64), cs16


def stream_len(rx, superblocks: int) -> int:
    """Samples that make exactly `superblocks` superblocks of rx."""
    wb = rx._wb
    return (superblocks * rx.wb_k - 1) * wb["advance"] + wb["wide_len"]


def chunk_sizes(adv: int, k: int, total: int) -> list:
    """Chunk lengths in samples adding up to `total`: one sample, a prime,
    exactly one advance, several superblocks in one call, then a cycle of
    odd lengths (one short of an advance, one sample, a prime, two
    advances and three)."""
    sizes = [1, 7919, adv, 3 * k * adv + 12345]
    cycle = [adv - 1, 1, PRIME, 2 * adv + 3]
    while sum(sizes) < total:
        sizes.append(cycle[(len(sizes) - 4) % len(cycle)])
    sizes[-1] -= sum(sizes) - total
    return [s for s in sizes if s]


def chunks(stream: np.ndarray, sizes: list) -> list:
    """The stream cut into chunks of `sizes` samples (a cs16 stream's
    samples are I/Q pairs)."""
    stride = 2 if stream.dtype == np.int16 else 1
    edges = np.cumsum([0] + sizes) * stride
    return [stream[a:b] for a, b in zip(edges[:-1], edges[1:])]


class Spy:
    """Keeps, for each superblock rx runs, its float32 windows as the
    superblock step receives them (cs16 scaled as the card scales it;
    their copy to the host waits for the device) and the packed words
    handed to the fleet engine."""

    def __init__(self, rx, windows: bool = True):
        self.windows, self.packed = [], []
        superblock, post = rx._superblock, rx._post_demod_fused

        def spy_superblock(wr, wi, i16):
            f = (lambda t: t.to(torch.float32) * (1.0 / 32768.0)) if i16 \
                else (lambda t: t)
            self.windows.append((f(wr).cpu().clone(), f(wi).cpu().clone()))
            return superblock(wr, wi, i16)

        def spy_post(fused):
            self.packed.append(np.array(fused, copy=True))
            return post(fused)
        if windows:
            rx._superblock = spy_superblock
        rx._post_demod_fused = spy_post


def assert_same_windows(a: list, b: list) -> None:
    assert len(a) == len(b) > 0
    for s, ((ar, ai), (br, bi)) in enumerate(zip(a, b)):
        assert torch.equal(ar, br) and torch.equal(ai, bi), s


def assert_same_packed(a: list, b: list) -> None:
    assert len(a) == len(b) > 0
    for s, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"superblock {s}")


def assert_same_decode(a, b) -> None:
    """Each channel's lock, CRC tallies and display, and sym_quality."""
    for c in range(a.channels):
        assert a.locked(c) == b.locked(c), c
        assert a.crc_counts(c) == b.crc_counts(c), c
        assert a.display(c).as_dict() == b.display(c).as_dict(), c
    np.testing.assert_array_equal(a.sym_quality, b.sym_quality)
