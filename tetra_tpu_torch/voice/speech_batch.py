"""Batched speech channel decoding: every full traffic slot and every
surviving half of a superblock in one trellis pass on the caller's device
(EN 300 395-2 clause 5, the conventions of voice/channel.py).

decode_slot and decode_half_slot (voice/channel.py) decode one kind of
block a call and reorder and check each row in a Python loop.  Here the
four codes of a superblock run as rows of ONE 112-step trellis (one
kernel launch on the card, ops/speech_kernel.py): a full slot's class 1
(112 steps, truncated) and class 2 (72 steps, zero terminated), a half's
class 1 (56, truncated) and class 2 (38, zero terminated).  A shorter code is right-aligned and led in by steps of the
all-zero codeword at amplitude LEAD (+LEAD on every mother bit: the
encoder's own state-0 start), so it reaches its first data step in state
0 and every other state trails by at least 6 * LEAD, more than any path's
gain over the data (at most 6 x 112 with soft bits within +-1; the
callers' bits are hard, or soft within +-2 in the tests), so the
decisions over the data are those of a decoder started in state 0, bit
for bit.  A row ends on its best state (truncated) or on state 0.  The
CRC-8 and CRC-4 are GF(2) matrices and the reordering to codec order is
one gather; nothing loops over rows.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import params as P
from ..ops import speech_kernel
from . import channel as vc

T_STEPS = 112                 # the longest code: a full slot's class 1
LEAD = 1024.0                 # soft amplitude of the lead-in steps

# (n_info steps, puncturer, coded bits, truncated) of the four row groups
_GROUPS = ((vc.N_C1, P.PUNCT_112_168, vc.N_C1_CODED, True),
           (vc.N_C2_BLOCK, P.PUNCT_72_162, vc.N_C2_CODED, False),
           (vc.N_CLASS1, P.PUNCT_112_168, vc.N_HC1_CODED, True),
           (vc.N_HC2_BLOCK, P.PUNCT_38_80, vc.N_HC2_CODED, False))


@lru_cache(maxsize=8)
def _tables(device: torch.device):
    """Per device: each group's flat positions in the (T_STEPS * 3) trellis
    input and the codec reorder gathers of a slot and a half."""
    to = lambda a, dt=torch.int64: torch.from_numpy(
        np.ascontiguousarray(a)).to(device=device, dtype=dt)
    pos = []
    for n_info, punct, n_coded, _ in _GROUPS:
        idx = np.asarray(P.puncture_indices(punct, n_coded), np.int64)
        pos.append(to((T_STEPS - n_info) * 3 + idx))
    # codec position -> index in [class 0 | class 1 | class 2]
    slot = np.empty(2 * vc.N_FRAME_BITS, np.int64)
    half = np.empty(vc.N_FRAME_BITS, np.int64)
    cur = 0
    for tbl in (vc._CLASS0_POS, vc._CLASS1_POS, vc._CLASS2_POS):
        for i, posn in enumerate(tbl):
            for frame in range(2):
                slot[frame * vc.N_FRAME_BITS + posn - 1] = cur + 2 * i + frame
            half[posn - 1] = cur // 2 + i
        cur += 2 * len(tbl)
    return dict(pos=pos, slot=to(slot), half=to(half))


@lru_cache(maxsize=16)
def _crc_matrix(device, poly: int, n: int, width: int) -> torch.Tensor:
    """(n, width) generator of a CRC with init 0 over n bits: being
    linear, its bits are the XOR of those of the input's unit vectors."""
    fn = vc.crc8_bits if width == 8 else vc.crc4_bits
    g = np.stack([fn(np.eye(n, dtype=np.uint8)[k], poly) for k in range(n)])
    return torch.from_numpy(g.astype(np.int32)).to(device)


def decode_speech(full: torch.Tensor, half: torch.Tensor,
                  profile: vc.CodecProfile | None = None):
    """Speech channel decoding of (Nf, 432) full traffic slots and (Nh,
    216) surviving second halves, as soft bits on one device (+1 ~ bit 0,
    -1 ~ bit 1; hard bits as 1 - 2b).  Returns, on that device,
    (frames (Nf, 2, 137) uint8, bfi (Nf,) bool, half frames (Nh, 137)
    uint8, half bfi (Nh,) bool): the codec frames in codec order and the
    bad-frame flag (class-2 CRC-8, CRC-4 of a half, failed)."""
    p = profile or vc.get_profile()
    dev = full.device
    tab = _tables(dev)
    nf, nh = full.shape[0], half.shape[0]
    t3f = full.to(torch.float32)[:, vc._decode_perm(
        vc._IL_LINES, p.il_transposed, p.mux_order, dev)]
    t3h = half.to(torch.float32)[:, vc._decode_perm(
        vc._IL_HALF_LINES, p.il_transposed, p.mux_order, dev)]
    f_c1 = vc.N_C0 + vc.N_C1_CODED
    h_c1 = vc.N_CLASS0 + vc.N_HC1_CODED
    coded = (t3f[:, vc.N_C0:f_c1], t3f[:, f_c1:],
             t3h[:, vc.N_CLASS0:h_c1], t3h[:, h_c1:h_c1 + vc.N_HC2_CODED])
    rows = (nf, nf, nh, nh)
    x = torch.zeros((2 * (nf + nh), T_STEPS * 3), dtype=torch.float32,
                    device=dev)
    trunc = torch.empty(2 * (nf + nh), dtype=torch.bool, device=dev)
    r0 = 0
    for (n_info, _, _, tr), pos, c, n in zip(_GROUPS, tab["pos"], coded,
                                             rows):
        x[r0:r0 + n, :(T_STEPS - n_info) * 3] = LEAD
        x[r0:r0 + n, pos] = c
        trunc[r0:r0 + n] = tr
        r0 += n
    bits = speech_kernel.trellis(x.view(-1, T_STEPS, 3), trunc)
    c1f, c2f = bits[:nf], bits[nf:2 * nf, T_STEPS - vc.N_C2_BLOCK:]
    c1h = bits[2 * nf:2 * nf + nh, T_STEPS - vc.N_CLASS1:]
    c2h = bits[2 * nf + nh:, T_STEPS - vc.N_HC2_BLOCK:]

    g8 = _crc_matrix(dev, p.crc8_poly, vc.N_C2_INFO, 8)
    g4 = _crc_matrix(dev, p.crc4_poly, vc.N_CLASS2, 4)

    def crc_bad(info, got, g):
        calc = (info.to(torch.int32)[:, :, None] * g[None]).sum(dim=1) & 1
        return (calc != got.to(torch.int32)).any(dim=1)

    info_f = c2f[:, :vc.N_C2_INFO]
    seq_f = torch.cat([(t3f[:, :vc.N_C0] < 0).to(torch.uint8), c1f,
                       info_f], dim=1)
    frames = seq_f[:, tab["slot"]].view(nf, 2, vc.N_FRAME_BITS)
    bfi = crc_bad(info_f, c2f[:, vc.N_C2_INFO:vc.N_C2_INFO + 8], g8)
    info_h = c2h[:, :vc.N_CLASS2]
    seq_h = torch.cat([(t3h[:, :vc.N_CLASS0] < 0).to(torch.uint8), c1h,
                       info_h], dim=1)
    hframes = seq_h[:, tab["half"]]
    hbfi = crc_bad(info_h, c2h[:, vc.N_CLASS2:vc.N_CLASS2 + 4], g4)
    return frames, bfi, hframes, hbfi
