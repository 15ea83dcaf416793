"""tetra-tx CLI: generate TETRA downlink IQ captures (port of
tetra_tpu/apps/tetra_tx.py; every flag of the reference, plus --device).

Counterpart of apps/tetra_rx: synthesizes a full downlink (SYNC/BSCH
broadcast, NDB signalling, optional voice traffic carrying real encoded
speech) and writes baseband IQ that tetra_rx — or the reference plugin —
can decode.  The reference has no TX path at all; this closes the loop for
self-contained end-to-end operation, capture generation for regression
fixtures, and on-air-format interop testing.

Speech sources for --voice-tn:
  --speech vowel        built-in synthetic vowel (default)
  --speech file.wav     8 kHz mono s16 WAV, encoded live by the ACELP
                        analysis-by-synthesis encoder (voice/acelp.py)

Output: complex64 raw IQ, 36 kHz single channel, or --wideband N for an
N x 25 kHz multiplex with independent cells on selected channel indices.
The modulator, the resampler and the channel model run on --device (the
current CUDA device by default, the CPU when asked for).  --snr/--cfo draw
their noise from a torch.Generator seeded with 7, so the noise samples
differ from the reference CLI's (a jax.random key); a clean capture is the
reference's to float32 rounding.

Usage:
  python -m tetra_tpu_torch.apps.tetra_tx out.cf32 --slots 400
         [--voice-tn 2] [--speech voice.wav] [--snr 30] [--cfo 300]
         [--mcc 262 --mnc 1234] [--device D]
  python -m tetra_tpu_torch.apps.tetra_tx wide.cf32 --wideband 16
         --channels 0,3,9
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import exact_float32, resolve_device
from ..rx.tdma import TdmaTime
from ..tx import cell as txcell
from ..tx.modulator import modulate


def _speech_pcm(spec: str, rate: int = 8000) -> np.ndarray:
    """Load the speech source as 8 kHz s16 mono samples."""
    if spec == "vowel":
        t = np.arange(rate * 4) / rate
        f0 = 110 * (1 + 0.02 * np.sin(2 * np.pi * 2.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / rate
        x = sum(np.cos(h * phase) / h for h in range(1, 30))
        # simple two-pole formant colouring without scipy dependence
        y = np.zeros_like(x)
        for fc, bw in ((700, 110), (1200, 140), (2600, 250)):
            r = np.exp(-np.pi * bw / rate)
            th = 2 * np.pi * fc / rate
            b1, b2 = 2 * r * np.cos(th), -r * r
            y1 = y2 = 0.0
            out = np.empty_like(x)
            for i, v in enumerate(x):
                y0 = v + b1 * y1 + b2 * y2
                out[i] = y0
                y2, y1 = y1, y0
            x = out
        return (x / np.abs(x).max() * 12000).astype(np.int16)
    import wave
    with wave.open(spec, "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2, \
            "need 8 kHz mono s16 WAV"
        assert w.getframerate() == rate, f"need {rate} Hz WAV"
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.copy()


def _voice_gen(pcm: np.ndarray):
    """Slot generator: loops the PCM through the ACELP encoder."""
    from ..voice.acelp import AcelpEncoder
    enc = AcelpEncoder()
    n_slots = max(1, len(pcm) // 480)
    state = {"i": 0}

    def gen():
        s = state["i"] % n_slots
        state["i"] += 1
        return enc.encode_slot(pcm[s * 480:(s + 1) * 480])

    return gen


def _tx_crypto(args, cfg: txcell.CellConfig):
    """Air-interface encryption state for the TX side from a keystore file
    (same text format the reference documents, tetra_crypto.c:306-319)."""
    if not args.keystore:
        return None
    from ..crypto.state import KEYTYPE_CCK_SCK, CryptoState, KeyStore
    cs = CryptoState(store=KeyStore.load(args.keystore))
    cs.cc, cs.la = cfg.cc, cfg.la
    cs.cn, cs.hn = cfg.main_carrier, cfg.hyperframe
    if args.cck_id >= 0:
        cs.cck_id = args.cck_id
    else:
        for k in cs.store.keys:
            if (k.key_type == KEYTYPE_CCK_SCK and k.mcc == cfg.mcc
                    and k.mnc == cfg.mnc):
                cs.cck_id = k.key_num
                break
    cs.update_network(cfg.mcc, cfg.mnc)
    if cs.cck is None:
        raise SystemExit("keystore has no CCK/SCK key for this network")
    return cs


def _one_channel(args, cfg: txcell.CellConfig, seed: int) -> np.ndarray:
    voice_slots = None
    if args.voice_tn:
        voice_slots = {args.voice_tn: _voice_gen(_speech_pcm(args.speech))}
    bits, _ = txcell.downlink_bits(
        cfg, args.slots, start=TdmaTime(mn=1, fn=1, tn=1, sn=1),
        payload_rng=np.random.default_rng(seed),
        voice_slots=voice_slots, crypto=_tx_crypto(args, cfg))
    return modulate(bits[None, :], device=args.device)[0].cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tetra_tx", description=__doc__)
    ap.add_argument("output", help="output IQ file (complex64)")
    ap.add_argument("--slots", type=int, default=400,
                    help="downlink slots to generate (510 bits each)")
    ap.add_argument("--mcc", type=int, default=262)
    ap.add_argument("--mnc", type=int, default=1234)
    ap.add_argument("--cc", type=int, default=7)
    ap.add_argument("--carrier", type=int, default=3600)
    ap.add_argument("--voice-tn", type=int, default=0,
                    help="timeslot (1-4) carrying voice traffic; 0 = none")
    ap.add_argument("--speech", default="vowel",
                    help="'vowel' or an 8 kHz mono s16 WAV file")
    ap.add_argument("--snr", type=float, default=0.0,
                    help="add AWGN at this SNR (dB); 0 = clean")
    ap.add_argument("--cfo", type=float, default=0.0,
                    help="carrier frequency offset (Hz)")
    ap.add_argument("--keystore", default=None,
                    help="encrypt the downlink with this keystore file "
                         "(CCK air-interface encryption; tetra_rx decrypts "
                         "with the same file)")
    ap.add_argument("--cck-id", type=int, default=-1,
                    help="CCK key number; default: first CCK in the store")
    ap.add_argument("--wideband", type=int, default=0,
                    help="emit an N x 25 kHz wideband multiplex")
    ap.add_argument("--channels", default="0",
                    help="comma-separated channel indices for --wideband")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs everything on the host)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    exact_float32()

    if args.wideband:
        from ..tx.wideband import assemble_wideband
        chans = {}
        for j, kstr in enumerate(args.channels.split(",")):
            k = int(kstr)
            cfg = txcell.CellConfig(
                mcc=args.mcc, mnc=args.mnc, cc=(args.cc + j) % 64,
                main_carrier=args.carrier + k)
            chans[k] = _one_channel(args, cfg, seed=100 + j)
        iq = assemble_wideband(chans, args.wideband, device=args.device)
        rate = args.wideband * 25_000
    else:
        cfg = txcell.CellConfig(mcc=args.mcc, mnc=args.mnc, cc=args.cc,
                                main_carrier=args.carrier)
        iq = _one_channel(args, cfg, seed=100)
        rate = 36_000

    if args.snr or args.cfo:
        from ..tx.channel import channel
        gen = torch.Generator(device=args.device).manual_seed(7)
        iq = channel(np.asarray(iq)[None, :], gen,
                     snr_db=args.snr if args.snr else 200.0,
                     cfo_hz=args.cfo, sample_rate=float(rate),
                     device=args.device)[0].cpu().numpy()

    iq.astype(np.complex64).tofile(args.output)
    print(json.dumps({
        "output": args.output, "samples": int(len(iq)),
        "sample_rate": rate, "slots": args.slots,
        "duration_s": round(len(iq) / rate, 3),
        "voice_tn": args.voice_tn or None,
        "wideband": args.wideband or None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
