"""Voice pipeline: traffic SCH/F slots -> channel decode -> speech synthesis
(port of tetra_tpu/voice/pipeline.py; the channel decode runs on the
pipeline's torch device, the ACELP synthesis in C++ on the host).

Mirrors the reference voice path (tetra_lower_mac.c:287-372 +
osmotetra_dec.h:216-223): for each traffic timeslot, the descrambled 432
type-4 bits run through speech channel decoding and the ACELP synthesizer,
producing 480 samples of 8 kHz s16 audio per slot.  Like the reference, only
one active timeslot per TDMA frame feeds the audio output (the first traffic
slot seen in each frame).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import resolve_device
from ..rx.tdma import TdmaTime
from . import channel as vchannel
from .acelp import AcelpDecoder


@dataclass
class VoicePipeline:
    decoder: AcelpDecoder = field(default_factory=AcelpDecoder)
    audio: list = field(default_factory=list)
    last_frame: int = -1
    active_timeslot: int = -1
    slots_decoded: int = 0
    bad_frames: int = 0
    crypto_state: object = None   # optional CryptoState for encrypted voice
    # auto-resolve the codec-profile assumption space on repeated class-2
    # CRC failure (vchannel.ProfileCalibrator; clear traffic only)
    calibrate: bool = False
    calibrator: object = None
    # per-pipeline codec profile: None = the process default.  A resolved
    # calibration lands HERE, not in the global (ADVICE r3: with one
    # pipeline per channel, a mis-resolving noisy channel must not flip the
    # convention for every other channel; promote to the global explicitly
    # via vchannel.set_profile once channels agree).
    profile: object = None
    # the channel decode's torch device: the current CUDA device unless the
    # caller asks for the CPU
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.calibrate and self.calibrator is None:
            self.calibrator = vchannel.ProfileCalibrator(base=self._base,
                                                         device=self.device)

    def _base(self):
        return self.profile if self.profile is not None \
            else vchannel.get_profile()

    def calibration_status(self) -> dict | None:
        """Operator-visible calibration state (None when calibration is
        off); see ProfileCalibrator.status."""
        return self.calibrator.status() if self.calibrator is not None \
            else None

    def _gate(self, time: TdmaTime) -> bool:
        # active-timeslot gate (tetra_lower_mac.c:364-370)
        if time.fn != self.last_frame:
            self.active_timeslot = time.tn
            self.last_frame = time.fn
        return time.tn == self.active_timeslot

    def half(self, time: TdmaTime, type4: np.ndarray):
        """Stolen-slot voice callback: the surviving 216-bit second half of a
        traffic slot whose first half carries STCH (clause 19.4.4).

        The reference drops voice entirely in stolen slots; recovering the
        second frame is a capability extension (ROADMAP).  The stolen first
        frame's 240 samples are padded with silence so the audio clock stays
        at 480 samples/slot like put_voice_data (osmotetra_dec.h:216-223).
        With a crypto state the frame is decrypted as the slot's second
        frame: keystream bits 137-273 (the reference decrypts no half).
        """
        if not self._gate(time):
            return
        frame, bfi = vchannel.decode_half_slot(np.asarray(type4)[None],
                                               profile=self.profile,
                                               device=self.device)
        is_bad = bool(bfi[0])
        if self.calibrator is not None and self.crypto_state is None:
            resolved = self.calibrator.observe_half(type4, is_bad)
            if resolved is not None:
                # CRC-4 generator just resolved: adopt it into THIS
                # pipeline's profile and re-decode this half under it
                self.profile = resolved
                frame, bfi = vchannel.decode_half_slot(
                    np.asarray(type4)[None], profile=self.profile,
                    device=self.device)
                is_bad = bool(bfi[0])
        if self.crypto_state is not None:
            # the surviving frame is the slot's second: XOR the keystream
            # bits that lie over it in a full slot (bits 137-273)
            key = self.crypto_state.cck
            ks = (self.crypto_state.keystream_bits(
                key, time, 2 * vchannel.N_FRAME_BITS) if key else None)
            if ks is not None:
                frame[0] ^= ks[vchannel.N_FRAME_BITS:]
        self.slots_decoded += 1
        if is_bad:
            self.bad_frames += 1
        pcm = self.decoder.decode_frame(frame[0], bfi=is_bad)
        self.audio.append(np.zeros(240, np.int16))
        self.audio.append(pcm)

    def __call__(self, time: TdmaTime, type4: np.ndarray):
        """LowerMac voice callback: one traffic slot's descrambled bits."""
        if not self._gate(time):
            return
        frames, bfi = vchannel.decode_slot(type4[None], profile=self.profile,
                                           device=self.device)
        f2, is_bad = frames[0], bool(bfi[0])
        if self.calibrator is not None and self.crypto_state is None:
            resolved = self.calibrator.observe(type4, is_bad)
            if resolved is not None:
                # profile just resolved: adopt into THIS pipeline, re-decode
                self.profile = resolved
                frames, bfi = vchannel.decode_slot(type4[None],
                                                   profile=self.profile,
                                                   device=self.device)
                f2, is_bad = frames[0], bool(bfi[0])
        if self.crypto_state is not None:
            # encrypted traffic: XOR the CCK keystream off the decoded
            # codec frames (decrypt_voice_timeslot semantics -- the
            # reference carries that function but never calls it; here it
            # is wired into the voice path)
            self.crypto_state.decrypt_voice_bits(time, f2)
        self.slots_decoded += 1
        if is_bad:
            self.bad_frames += 1
        pcm = self.decoder.decode_slot(f2, bfi=is_bad)
        self.audio.append(pcm)

    def take_audio(self) -> np.ndarray:
        """Drain accumulated PCM (s16 @ 8 kHz)."""
        if not self.audio:
            return np.zeros(0, np.int16)
        out = np.concatenate(self.audio)
        self.audio.clear()
        return out
