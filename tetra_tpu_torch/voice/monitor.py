"""The fleet receiver's voice monitor: every call's speech on every carrier,
decoded a superblock at a time, TEA1-decrypted per carrier where the keys
are held, synthesised per call.

A call is one (carrier, timeslot).  After the fleet engine's dispatch
(rx/fleet.FleetEngine) a superblock's voice rows (full traffic slots, and
the surviving second half of each first-half steal) come here together:

1. decode: the rows' type-5 bits are uploaded once, descrambled with each
   carrier's scrambling sequence on the device and speech-decoded in one
   batched trellis pass (voice/speech_batch.py); the frames and bad-frame
   flags come back in one fetch;
2. decrypt: while the card decodes, each carrier's cipher state is read
   off the engine (its adopted cell, and the hyperframe, CCK id, location
   area and main carrier of the SYSINFO PDUs it decoded, latched across
   superblocks) and the TEA1 keystreams of every encrypted slot are made
   in one C++ call (crypto/tea_batch.py); they are XORed off the codec
   frames: keystream bits 0-273 over a full slot's two frames, bits
   137-273 over a half's surviving frame;
3. synthesise: every row to 480 samples of 8 kHz PCM on its call's own
   ACELP decoder, made on the call's first synthesised slot: on a CUDA
   device one kernel launch a superblock with the decoders kept on the
   card (ops/acelp_kernel.AcelpCardBank), on the CPU one C++ call
   (voice/acelp.AcelpBank), bit for bit alike.

A carrier's voice is taken from its first good SYNC PDU on, which sets
its slots' times (and so the timeslot of each call).  A carrier whose
network (MCC, MNC) has no entry in the keystore passes
its frames through as sent (crypt CLEAR).  A carrier on a keyed network
decrypts once its cipher state and key are known (DECRYPTED); until then
its frames are passed through unsynthesised, as silence (WITHHELD).  A
superblock's voice rows take their carrier's cipher state as it stands
at the superblock's end.  The hyperframe number is latched with the
multiframe of the SYSINFO PDU that carried it, and each row's hyperframe
is counted from there: the row's multiframe within 30 of the latch's,
before or after it, across a wrap of the multiframe (60 -> 1, where the
hyperframe advances).  A carrier whose last hyperframe PDU lies 30
multiframes or more from a row gives that row a wrong hyperframe.

Each superblock's output is one VoiceBlock of arrays, in a ring of
RING_BLOCKS that the consumer drains with take() (the receiver's
take_voice()); an undrained ring drops its oldest block.  A receiver's
checkpoint (save_state) holds none of the monitor's state: a restored
receiver's monitor starts anew.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from .. import params as P
from .. import spans as S
from ..crypto import state as cstate
from ..crypto import tea_batch
from ..ops.acelp_kernel import AcelpCardBank
from ..rx import fec as rx_fec
from .acelp import FRAME_BITS, AcelpBank
from .speech_batch import decode_speech

CLEAR, DECRYPTED, WITHHELD = 0, 1, 2
FULL, HALF = 0, 1
RING_BLOCKS = 64
_SLOT_BITS = 432
_KS_BYTES = (2 * FRAME_BITS + 7) // 8


@dataclass
class VoiceBlock:
    """One superblock's voice rows, in the engine's order (carrier by
    carrier, each in time order):

    carrier (N,) int64, timeslot (N,) int64 (1-4): the call;
    time (N, 4) int64: the slot's (hn, mn, fn, tn) as the MAC stamped it;
    slot (N,) int64: the carrier's slot count at the slot;
    kind (N,) int8: FULL (two frames) or HALF (the second frame of a
        first-half steal; frame 0 is zeros);
    frames (N, 2, 137) uint8: the codec frames, decrypted where crypt is
        DECRYPTED;
    bfi (N, 2) bool: the bad-frame flag of each frame (the class-2 CRC);
    crypt (N,) int8: CLEAR, DECRYPTED or WITHHELD;
    pcm (N, 480) int16: 8 kHz PCM, a half's first 240 samples and a
        withheld slot's all silence."""
    carrier: np.ndarray
    timeslot: np.ndarray
    time: np.ndarray
    slot: np.ndarray
    kind: np.ndarray
    frames: np.ndarray
    bfi: np.ndarray
    crypt: np.ndarray
    pcm: np.ndarray

    def __len__(self) -> int:
        return len(self.carrier)


def _bits(t1p: np.ndarray, pos: int, n: int) -> np.ndarray:
    """Field [pos, pos+n) of packed MSB-first rows, as int64."""
    b = np.unpackbits(t1p[:, pos // 8:(pos + n + 7) // 8 + 1], axis=1)
    off = pos % 8
    return b[:, off:off + n].astype(np.int64) @ (1 << np.arange(
        n - 1, -1, -1, dtype=np.int64))


class VoiceMonitor:
    """Voice for a FleetEngine of `channels` carriers on `device`, with the
    keystore at `keystore` (None: every carrier is clear); `threads`
    workers for the keystreams, and on a CPU device for the synthesis."""

    def __init__(self, channels: int, device, keystore: str | None = None,
                 threads: int = 1):
        self.channels = channels
        self.device = device
        self.threads = max(1, int(threads))
        self.store = (cstate.KeyStore.load(keystore) if keystore
                      else cstate.KeyStore())
        self.bank = (AcelpCardBank(device)
                     if torch.device(device).type == "cuda"
                     else AcelpBank(self.threads))
        self.ring = collections.deque(maxlen=RING_BLOCKS)
        self.dropped = 0            # blocks the full ring dropped
        # each carrier's descrambling sequence on the device, and its code
        self._scr = torch.zeros((channels, _SLOT_BITS), dtype=torch.uint8,
                                device=device)
        self._scr_code = np.full(channels, -1, np.int64)
        # latched SYSINFO of each carrier: hyperframe, CCK id, location
        # area, main carrier (-1 until seen)
        self.hn = np.full(channels, -1, np.int64)
        self.hn_mn = np.ones(channels, np.int64)   # multiframe of hn's PDU
        self.cck_id = np.full(channels, -1, np.int64)
        self.la = np.full(channels, -1, np.int64)
        self.cn = np.full(channels, -1, np.int64)
        self._eck: dict = {}
        self._timed = np.zeros(channels, bool)

    # -- the superblock's stage --------------------------------------------

    def process(self, engine, rows: np.ndarray, kind: np.ndarray,
                t5p: np.ndarray, meta: np.ndarray, times: np.ndarray,
                type1p: np.ndarray, ok: np.ndarray) -> None:
        """One superblock: rows (N,) the voice rows of the engine's batch
        (kind FULL or HALF), t5p/meta/times/type1p/ok the batch's arrays
        (every row: the SYSINFO PDUs are read from them too)."""
        with S.span("voice"):
            self._latch_sysinfo(meta, type1p, ok, times)
            rows, kind = self._timed_rows(meta, ok, rows, kind)
            chans = meta[rows, 0]
            n = len(rows)
            dev_out = None
            if n:
                with S.span("voice.decode"):
                    dev_out = self._decode_enqueue(engine, chans, t5p[rows],
                                                   kind)
            with S.span("voice.decrypt"):
                crypt, ks = self._keystreams(engine, chans, times[rows])
            frames = np.zeros((n, 2, FRAME_BITS), np.uint8)
            bfi = np.zeros((n, 2), bool)
            if n:
                with S.span("voice.decode"):
                    host = dev_out.cpu().numpy()
                frames[:] = host[:, :2 * FRAME_BITS].reshape(n, 2, FRAME_BITS)
                bfi[:] = host[:, 2 * FRAME_BITS:].astype(bool)
            with S.span("voice.decrypt"):
                dec = np.nonzero(crypt == DECRYPTED)[0]
                if len(dec):
                    ks[kind[dec] == HALF, :FRAME_BITS] = 0
                    frames[dec] ^= ks.reshape(-1, 2, FRAME_BITS)
            tn = times[rows, 3]
            with S.span("voice.acelp"):
                pcm = self.bank.decode(
                    chans * 4 + (tn - 1) % 4, frames, bfi,
                    np.where(crypt == WITHHELD, 2, kind).astype(np.int8))
            S.count("voice.slots", int((kind == FULL).sum()))
            S.count("voice.halves", int((kind == HALF).sum()))
            S.count("voice.bad_frames", int(bfi.sum()))
            S.count("voice.frames_decrypted",
                    int(2 * len(dec) - (kind[dec] == HALF).sum()))
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(VoiceBlock(
                carrier=chans.astype(np.int64), timeslot=tn.astype(np.int64),
                time=times[rows, :4].astype(np.int64),
                slot=meta[rows, 3].astype(np.int64), kind=kind.astype(np.int8),
                frames=frames, bfi=bfi, crypt=crypt, pcm=pcm))

    def take(self) -> list:
        """The VoiceBlocks of the superblocks since the last take, oldest
        first (the ring is emptied)."""
        out = list(self.ring)
        self.ring.clear()
        return out

    # -- parts ---------------------------------------------------------------

    def _timed_rows(self, meta: np.ndarray, ok: np.ndarray,
                    rows: np.ndarray, kind: np.ndarray):
        """The voice rows of carriers whose time a good SYNC PDU has set:
        every row of a carrier timed in an earlier superblock, and the
        rows after its first good SYNC PDU in this one.  Before it a
        carrier's slot times, and so its calls' timeslots, are its own
        count's, not the cell's."""
        sb1 = np.nonzero((meta[:, 1] == P.TPSAP_T_SB1) & ok)[0]
        first = np.full(self.channels, len(meta), np.int64)
        np.minimum.at(first, meta[sb1, 0], sb1)
        chans = meta[rows, 0]
        keep = self._timed[chans] | (rows > first[chans])
        self._timed[meta[sb1, 0]] = True
        return rows[keep], kind[keep]

    def _decode_enqueue(self, engine, chans: np.ndarray, t5p: np.ndarray,
                        kind: np.ndarray) -> torch.Tensor:
        """Enqueue the rows' speech decode; returns the (N, 276) uint8 result
        on the device: the two frames' 274 bits, then the two flags."""
        dev = self.device
        codes = engine.scramb[chans]
        stale = np.unique(chans[self._scr_code[chans] != codes])
        if len(stale):
            ks = np.stack([rx_fec.keystream(int(engine.scramb[c]),
                                            _SLOT_BITS) for c in stale])
            self._scr[torch.from_numpy(stale).to(dev)] = \
                torch.from_numpy(ks).to(dev)
            self._scr_code[stale] = engine.scramb[stale]
        n = len(chans)
        packed = torch.from_numpy(np.ascontiguousarray(t5p)).to(dev)
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        bits = ((packed[:, :, None] >> shifts) & 1).view(n, -1)[:, :_SLOT_BITS]
        type4 = bits ^ self._scr[torch.from_numpy(chans).to(dev)]
        soft = 1.0 - 2.0 * type4.to(torch.float32)
        kd = torch.from_numpy(kind).to(dev)
        full_i = torch.nonzero(kd == FULL).flatten()
        half_i = torch.nonzero(kd == HALF).flatten()
        f, b, hf, hb = decode_speech(soft[full_i], soft[half_i, :216])
        out = torch.zeros((n, 2 * FRAME_BITS + 2), dtype=torch.uint8,
                          device=dev)
        out[full_i, :2 * FRAME_BITS] = f.reshape(-1, 2 * FRAME_BITS)
        out[full_i, 2 * FRAME_BITS] = b.to(torch.uint8)
        out[full_i, 2 * FRAME_BITS + 1] = b.to(torch.uint8)
        out[half_i, FRAME_BITS:2 * FRAME_BITS] = hf
        out[half_i, 2 * FRAME_BITS + 1] = hb.to(torch.uint8)
        return out

    def _latch_sysinfo(self, meta: np.ndarray, type1p: np.ndarray,
                       ok: np.ndarray, times: np.ndarray) -> None:
        """Latch each carrier's hyperframe (with the multiframe of its
        PDU), CCK id, location area and main carrier from the batch's good
        SYSINFO PDUs (MAC broadcast type 0 in an SB2 block; the last of
        each kind a carrier decoded)."""
        rows = np.nonzero((meta[:, 1] == P.TPSAP_T_SB2) & ok)[0]
        if not len(rows):
            return
        t1 = type1p[rows]
        rows = rows[_bits(t1, 0, 4) == 0b1000]
        if not len(rows):
            return
        t1 = type1p[rows]
        chans = meta[rows, 0]
        cck = _bits(t1, 43, 1) == 1
        val = _bits(t1, 44, 16)
        for target, src, pick in ((self.la, _bits(t1, 82, 14), slice(None)),
                                  (self.cn, _bits(t1, 4, 12), slice(None)),
                                  (self.cck_id, val, cck),
                                  (self.hn, val, ~cck),
                                  (self.hn_mn, times[rows, 1], ~cck)):
            c, v = chans[pick], src[pick]
            # the last of each carrier's rows (rows run in time order)
            last = len(c) - 1 - np.unique(c[::-1], return_index=True)[1]
            target[c[last]] = v[last]

    def _keystreams(self, engine, chans: np.ndarray, times: np.ndarray):
        """(crypt (N,) int8, keystream bits (D, 274) of the DECRYPTED rows in
        order)."""
        n = len(chans)
        crypt = np.full(n, CLEAR, np.int8)
        if not n or not self.store.nets:
            return crypt, np.zeros((0, 2 * FRAME_BITS), np.uint8)
        # each carrier's key (a few distinct cells), then each row's
        car, at = np.unique(chans, return_inverse=True)
        ident = np.stack([engine.cell_mcc[car], engine.cell_mnc[car],
                          engine.cell_cc[car], self.cck_id[car],
                          self.la[car], self.cn[car]], axis=1)
        uniq, inv = np.unique(ident, axis=0, return_inverse=True)
        key_of = np.full(len(uniq), -1, np.int64)
        keys = []
        for u, (m, nc, c, k, a, cn) in enumerate(uniq.tolist()):
            net = self.store.network_info(m, nc)
            if net is None:
                continue
            key_of[u] = -2                      # keyed network: withheld
            eck = self._cell_key(net, m, nc, c, k, a, cn)
            if eck is not None:
                key_of[u] = len(keys)
                keys.append(np.frombuffer(eck, np.uint8))
        hn = self.row_hn(chans, times[:, 1])
        ko = key_of[inv.reshape(-1)][at.reshape(-1)]
        crypt[ko == -2] = WITHHELD
        dec = (ko >= 0) & (hn >= 0)
        crypt[(ko >= 0) & ~dec] = WITHHELD
        crypt[dec] = DECRYPTED
        t = times[dec]
        iv = ((t[:, 3] - 1) | (t[:, 2] << 2) | (t[:, 1] << 7)
              | ((hn[dec] & 0x7FFF) << 13))
        ks = tea_batch.tea1_batch(iv, ko[dec], np.stack(keys) if keys else
                                  np.zeros((1, 10), np.uint8), _KS_BYTES,
                                  self.threads)
        return crypt, np.unpackbits(ks, axis=1)[:, :2 * FRAME_BITS]

    def row_hn(self, chans: np.ndarray, mn: np.ndarray) -> np.ndarray:
        """The hyperframe of rows of carriers `chans` in multiframes `mn`
        (-1 where the carrier's is not known): the latched number, one
        more where the row lies past a wrap of the multiframe after the
        latch's, one less where it lies before a wrap before it."""
        hn, at = self.hn[chans], self.hn_mn[chans]
        d = (mn - at + 30) % 60 - 30
        return np.where(hn >= 0, hn + (at - 1 + d) // 60, -1)

    def _cell_key(self, net, mcc, mnc, cc, cck_id, la, cn):
        """The TEA1 encryption key of a cell, or None where the CCK id,
        the SYSINFO or the key is not known yet, or the network's
        algorithm is not TEA1."""
        if net.ksg_type != cstate.KSG_TEA1 or min(cck_id, la, cn) < 0:
            return None
        k = (mcc, mnc, cc, cck_id, la, cn)
        if k not in self._eck:
            key = next((x for x in self.store.keys if x.mcc == mcc
                        and x.mnc == mnc and x.key_num == cck_id
                        and x.key_type == cstate.KEYTYPE_CCK_SCK), None)
            self._eck[k] = None if key is None else \
                cstate.tb5(cn, la, cc, key.key)
        return self._eck[k]
