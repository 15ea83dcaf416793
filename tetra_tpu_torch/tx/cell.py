"""Downlink cell simulator: generates a continuous TETRA downlink bit stream.

A copy of tetra_tpu/tx/cell.py, its voice, slot-stealing and crypto arms
included (the speech channel coder is voice.channel, the keystreams
crypto.state.CryptoState).

The reference has no test fixtures at all (SURVEY.md section 4); this module
is the golden TX the RX stack is validated against: SYNC bursts carrying
SYNC/SYSINFO PDUs on the BSCH/BNCH slot rules, AACH broadcast blocks, and
normal bursts carrying MAC-RESOURCE or arbitrary payload bits, assembled
slot-by-slot exactly as a base station would emit them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import params as P
from ..rx.tdma import TdmaTime, is_bsch
from . import burst as burst_mod
from . import fec_enc


def _uint_to_bits(val: int, n: int) -> np.ndarray:
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def build_sync_pdu(cc: int, time: TdmaTime, mcc: int, mnc: int) -> np.ndarray:
    """60-bit SYNC PDU (21.4.4.2 + D-MLE-SYNC)."""
    parts = [
        _uint_to_bits(0, 4),            # system code (pi/4 DQPSK)
        _uint_to_bits(cc, 6),
        _uint_to_bits(time.tn - 1, 2),
        _uint_to_bits(time.fn, 5),
        _uint_to_bits(time.mn, 6),
        _uint_to_bits(0, 2),            # sharing mode
        _uint_to_bits(0, 3),            # TS reserved frames
        _uint_to_bits(0, 1),            # U-plane DTX
        _uint_to_bits(0, 1),            # frame 18 extension
        _uint_to_bits(0, 1),            # reserved
        _uint_to_bits(mcc, 10),         # D-MLE-SYNC
        _uint_to_bits(mnc, 14),
        _uint_to_bits(0, 2),            # neighbour cell broadcast
        _uint_to_bits(0, 2),            # cell service level
        _uint_to_bits(0, 1),            # late entry info
    ]
    bits = np.concatenate(parts)
    assert len(bits) == 60
    return bits


def build_sysinfo_pdu(main_carrier: int, freq_band: int, hyperframe: int,
                      la: int, bs_service_details: int,
                      freq_offset: int = 0, duplex_spacing: int = 0,
                      reverse_operation: int = 0,
                      cck_id: int | None = None) -> np.ndarray:
    """124-bit BROADCAST/SYSINFO PDU (21.4.4.1 + D-MLE-SYSINFO).

    The 17-bit field after the timeout carries EITHER the hyperframe number
    (cck_valid_no_hf=0) or the common cipher key id (cck_valid_no_hf=1);
    encrypted networks alternate between the two so receivers learn both
    (rx_bcast handles both arms, tetra_upper_mac.c:120-131).  Pass cck_id to
    emit the CCK arm."""
    parts = [
        _uint_to_bits(2, 2),            # MAC PDU type: broadcast
        _uint_to_bits(0, 2),            # broadcast subtype: sysinfo
        _uint_to_bits(main_carrier, 12),
        _uint_to_bits(freq_band, 4),
        _uint_to_bits(freq_offset, 2),
        _uint_to_bits(duplex_spacing, 3),
        _uint_to_bits(reverse_operation, 1),
        _uint_to_bits(0, 2),            # number of common SCH
        _uint_to_bits(4, 3),            # MS txpwr max cell
        _uint_to_bits(2, 4),            # rxlev access min
        _uint_to_bits(3, 4),            # access parameter
        _uint_to_bits(2, 4),            # radio DL timeout
        _uint_to_bits(0 if cck_id is None else 1, 1),  # cck_valid_no_hf
        _uint_to_bits(hyperframe if cck_id is None else cck_id, 16),
        _uint_to_bits(2, 2),            # option field: access code A
        _uint_to_bits(0, 20),
        # D-MLE-SYSINFO
        _uint_to_bits(la, 14),
        _uint_to_bits(0xFFFF, 16),      # subscriber class bitmap
        _uint_to_bits(bs_service_details, 12),
    ]
    bits = np.concatenate(parts)
    assert len(bits) == 124
    return bits


def build_aach(dl_usage: int, ul_usage: int) -> np.ndarray:
    """14-bit ACCESS-ASSIGN: header 3 (DL field1/UL field1), usage markers."""
    return np.concatenate([
        _uint_to_bits(3, 2), _uint_to_bits(dl_usage, 6),
        _uint_to_bits(ul_usage, 6)])


def build_resource_pdu(ssi: int, sdu_bits: np.ndarray,
                       fill_to: int = 124,
                       crypto=None, time=None,
                       second_half_stolen: bool = False) -> np.ndarray:
    """MAC-RESOURCE with SSI address carrying a TM-SDU (21.4.3.1).

    Header is 43 bits (type/fill/grant/enc/raf/len/addr-type + 24-bit SSI +
    power/slot-grant/chan-alloc absent); total PDU length is padded to a
    whole number of octets and encoded in the length indicator.

    second_half_stolen: emit length indicator 0x3E ("second half slot
    stolen", table 21.89) -- the PDU fills this half slot and announces the
    next half block is also STCH (clause 19.4.4).
    """
    header = 43
    if second_half_stolen:
        length_oct = 0x3E
        pad = fill_to - header - len(sdu_bits)
        assert pad >= 0
    else:
        total_bits = header + len(sdu_bits)
        length_oct = (total_bits + 7) // 8
        assert length_oct <= 0x12 and length_oct * 8 <= fill_to
        pad = length_oct * 8 - total_bits
    enc_mode = 1 if crypto is not None else 0
    bits = np.concatenate([
        _uint_to_bits(0, 2),            # MAC PDU type: MAC-RESOURCE
        _uint_to_bits(0, 1),            # fill bits (none)
        _uint_to_bits(0, 1),            # grant position
        _uint_to_bits(enc_mode, 2),     # encryption mode
        _uint_to_bits(0, 1),            # random access flag
        _uint_to_bits(length_oct, 6),   # length in octets
        _uint_to_bits(1, 3),            # address type SSI
        _uint_to_bits(ssi, 24),
        _uint_to_bits(0, 1),            # power control absent
        _uint_to_bits(0, 1),            # slot granting absent
        _uint_to_bits(0, 1),            # channel allocation absent
        np.asarray(sdu_bits, np.uint8),
        np.zeros(pad, np.uint8),
    ])
    if crypto is not None:
        # air-interface encryption: keystream over the TM-SDU portion
        # (the inverse of decrypt_mac_element, tetra_crypto.c:221-268)
        ks = crypto.keystream_bits(crypto.cck, time, len(bits) - header)
        bits[header:] ^= ks
    tail = np.zeros(fill_to - len(bits), np.uint8)
    # remainder of the slot after a length-delimited PDU: a NULL PDU would
    # follow in a real cell; zeros decode as a resource PDU with NULL address
    return np.concatenate([bits, tail])


def build_frag_start_pdu(ssi: int, frag: np.ndarray,
                         fill_to: int = 124) -> np.ndarray:
    """MAC-RESOURCE with length indicator 0x3F ("start of fragmentation"):
    the PDU fills the half slot and its TM-SDU part is the first fragment
    (rx_resrc START_FRAG branch expects the fragment to run to the end of
    the block, so `frag` must be exactly fill_to - 43 bits)."""
    header = 43
    assert len(frag) == fill_to - header
    return np.concatenate([
        _uint_to_bits(0, 2),    # MAC PDU type: MAC-RESOURCE
        _uint_to_bits(0, 1),    # fill bits (none)
        _uint_to_bits(0, 1),    # grant position
        _uint_to_bits(0, 2),    # encryption mode
        _uint_to_bits(0, 1),    # random access flag
        _uint_to_bits(0x3F, 6),  # length: start of fragmentation
        _uint_to_bits(1, 3),    # address type SSI
        _uint_to_bits(ssi, 24),
        _uint_to_bits(0, 1),    # power control absent
        _uint_to_bits(0, 1),    # slot granting absent
        _uint_to_bits(0, 1),    # channel allocation absent
        np.asarray(frag, np.uint8),
    ])


def build_frag_cont_pdu(frag: np.ndarray, fill_to: int = 124) -> np.ndarray:
    """MAC-FRAG continuation: [01][0][fill=0] + fragment filling the block
    (21.4.3.2; _rx_macfrag consumes everything after the 4 header bits)."""
    assert len(frag) == fill_to - 4
    return np.concatenate([
        _uint_to_bits(1, 2),    # MAC PDU type: FRAG/END
        _uint_to_bits(0, 1),    # subtype MAC-FRAG
        _uint_to_bits(0, 1),    # fill bits (none)
        np.asarray(frag, np.uint8),
    ])


def build_frag_end_pdu(frag: np.ndarray, fill_to: int = 124) -> np.ndarray:
    """MAC-END: [01][1][fill=0][grant-pos][len 6][slot-grant 0][chanalloc 0]
    + final fragment (21.4.3.3).  The length indicator covers header+fragment
    in octets; the fragment is zero-padded to the octet boundary (trailing
    pad after the SDU, like any length-delimited PDU)."""
    header = 13
    length_oct = (header + len(frag) + 7) // 8
    assert length_oct <= 0x12 and length_oct * 8 <= fill_to
    pad = length_oct * 8 - header - len(frag)
    bits = np.concatenate([
        _uint_to_bits(1, 2),    # MAC PDU type: FRAG/END
        _uint_to_bits(1, 1),    # subtype MAC-END
        _uint_to_bits(0, 1),    # fill bits
        _uint_to_bits(0, 1),    # position of grant
        _uint_to_bits(length_oct, 6),
        _uint_to_bits(0, 1),    # slot granting absent
        _uint_to_bits(0, 1),    # channel allocation absent
        np.asarray(frag, np.uint8),
        np.zeros(pad, np.uint8),
    ])
    tail = np.zeros(fill_to - len(bits), np.uint8)
    return np.concatenate([bits, tail])


def build_null_pdu(fill_to: int = 124) -> np.ndarray:
    """MAC-RESOURCE with NULL address (fills remainder of the slot)."""
    bits = np.concatenate([
        _uint_to_bits(0, 2),   # MAC PDU type: MAC-RESOURCE
        _uint_to_bits(0, 1),   # fill bits
        _uint_to_bits(0, 1),   # grant position
        _uint_to_bits(0, 2),   # encryption mode
        _uint_to_bits(0, 1),   # random access flag
        _uint_to_bits(0, 6),   # length indicator (0 -> reserved/slot)
        _uint_to_bits(0, 3),   # address type NULL
    ])
    pad = np.zeros(fill_to - len(bits), np.uint8)
    return np.concatenate([bits, pad])


@dataclass
class SlotRecord:
    """Ground truth for one transmitted slot."""
    time: TdmaTime
    kind: str                   # "sync" | "ndb"
    type1: dict = field(default_factory=dict)  # per-block type-1 payloads


@dataclass
class CellConfig:
    mcc: int = 262
    mnc: int = 1234
    cc: int = 7
    main_carrier: int = 3600
    freq_band: int = 3          # 390 MHz band
    la: int = 21
    bs_service_details: int = 0b111001110111
    hyperframe: int = 42


def downlink_bits(cfg: CellConfig, n_slots: int,
                  start: TdmaTime | None = None,
                  payload_rng: np.random.Generator | None = None,
                  voice_slots: dict | None = None,
                  crypto=None,
                  stolen_slots: set | None = None,
                  frag_message: tuple | None = None
                  ) -> tuple[np.ndarray, list[SlotRecord]]:
    """Generate `n_slots` consecutive downlink slots (510 bits each).

    SYNC bursts are emitted on BSCH slots (fn==18, tn by the mn rule of
    tetra_lower_mac.c:118-123); every other slot carries a normal burst with
    NDB payload blocks.  Returns (bits (n_slots*510,), ground-truth records).

    voice_slots: optional {tn: voice frame generator} - those timeslots emit
    traffic (NORM-1 bursts carrying speech channel-coded SCH/F payloads, with
    AACH dl_usage marking the slot as traffic).  The generator is called with
    no args and must return (2, 137) codec frame bits.

    stolen_slots: optional set of (fn, tn) - voice slots at those times are
    transmitted with training sequence 2 instead (clause 19.4.4 slot
    stealing): both half blocks carry STCH signalling, the first announcing
    the second via length indicator 0x3E.  A dict {(fn, tn): "both"|"first"}
    selects per-slot whether both halves are stolen or only the first --
    with "first" the second half block carries the slot's surviving speech
    frame (frame 2) as a 216-bit half-slot speech block.

    frag_message: optional ((fn, tn), sdu_bits) - transmit sdu_bits as a
    fragmented TM-SDU: START (fills the first half block) + MAC-FRAG
    (second half block) at (fn, tn), then MAC-END on the same timeslot of
    the NEXT frame (21.4.3.1-3 fragmentation; fragslots are per-timeslot).
    """
    from ..voice import channel as vchannel

    if payload_rng is None:
        payload_rng = np.random.default_rng(0)
    time = start.copy() if start else TdmaTime(mn=1, fn=1, tn=4)
    scramb = P.scramb_get_init(cfg.mcc, cfg.mnc, cfg.cc)
    out = []
    records = []
    frag_pending = None  # (tn, remaining_bits) awaiting the MAC-END slot
    for _ in range(n_slots):
        time.add_tn(1)
        is_voice = (voice_slots is not None and time.tn in voice_slots
                    and time.fn != 18 and not is_bsch(time))
        aach = build_aach(dl_usage=5 if is_voice else 2, ul_usage=0)
        bbk5 = fec_enc.encode_block(aach, P.TPSAP_T_BBK, scramb)
        if is_voice and stolen_slots and (time.fn, time.tn) in stolen_slots:
            steal = (stolen_slots[(time.fn, time.tn)]
                     if isinstance(stolen_slots, dict) else "both")
            sdu1 = np.concatenate([
                _uint_to_bits(2, 4),    # LLC: BL-UDATA
                _uint_to_bits(2, 3),    # MLE pdisc: CMCE
                _uint_to_bits(0x00, 5),  # CMCE: D-ALERT
                payload_rng.integers(0, 2, 40).astype(np.uint8)])
            stch1 = build_resource_pdu(ssi=0x654321, sdu_bits=sdu1,
                                       second_half_stolen=(steal == "both"))
            if steal == "both":
                # stolen traffic slot: NORM-2 burst, both halves STCH
                sdu2 = np.concatenate([
                    _uint_to_bits(2, 4),
                    _uint_to_bits(2, 3),
                    _uint_to_bits(0x03, 5),  # CMCE: D-CONNECT ACK
                    payload_rng.integers(0, 2, 40).astype(np.uint8)])
                stch2 = build_resource_pdu(ssi=0x654321, sdu_bits=sdu2)
                blk2_type5 = fec_enc.encode_block(stch2, P.TPSAP_T_NDB,
                                                  scramb)
                rec = dict(stch1=stch1, aach=aach, stch2=stch2)
            else:
                # first half stolen only: frame 2's speech survives in blk2
                frames = np.asarray(voice_slots[time.tn](), np.uint8)
                half3 = vchannel.encode_half_slot(frames.reshape(2, -1)[1])
                blk2_type5 = fec_enc.scramble(half3, scramb)
                rec = dict(stch1=stch1, aach=aach,
                           frames=frames.reshape(2, -1))
            b = burst_mod.build_norm_burst(
                fec_enc.encode_block(stch1, P.TPSAP_T_NDB, scramb),
                bbk5, blk2_type5, two_log_chan=True)
            records.append(SlotRecord(time.copy(), "stch", rec))
            out.append(b)
            continue
        if is_voice:
            frames = np.asarray(voice_slots[time.tn](), np.uint8)
            tx_frames = frames
            if crypto is not None:
                # air-interface voice encryption: XOR the CCK keystream over
                # the two 137-bit codec frames before channel coding (the
                # TX inverse of decrypt_voice_timeslot's post-decode sign
                # flip, tetra_crypto.c:270-302); records keep the plaintext
                ks = crypto.keystream_bits(crypto.cck, time, 137 * 2)
                tx_frames = frames.reshape(2, 137) ^ ks.reshape(2, 137)
            type3 = vchannel.encode_slot(tx_frames.reshape(-1))
            type5 = fec_enc.scramble(type3, scramb)
            b = burst_mod.build_norm_burst(
                type5[:216], bbk5, type5[216:], two_log_chan=False)
            records.append(SlotRecord(time.copy(), "voice",
                                      dict(frames=frames, aach=aach)))
            out.append(b)
            continue
        want_frag = (frag_message is not None
                     and (time.fn, time.tn) == frag_message[0]
                     and not is_bsch(time) and not is_voice)
        if want_frag or (frag_pending is not None
                         and frag_pending[0] == time.tn
                         and not is_bsch(time) and not is_voice):
            if want_frag:
                msg = np.asarray(frag_message[1], np.uint8)
                f1, f2 = msg[:81], msg[81:201]
                assert len(msg) > 201, "message too short to need fragmenting"
                ndb1 = build_frag_start_pdu(ssi=0x24680, frag=f1)
                ndb2 = build_frag_cont_pdu(np.pad(f2, (0, 120 - len(f2))))
                frag_pending = (time.tn, msg[201:])
                kind = "frag_start"
            else:
                ndb1 = build_frag_end_pdu(frag_pending[1])
                ndb2 = build_null_pdu()
                frag_pending = None
                kind = "frag_end"
            b = burst_mod.build_norm_burst(
                fec_enc.encode_block(ndb1, P.TPSAP_T_NDB, scramb),
                bbk5,
                fec_enc.encode_block(ndb2, P.TPSAP_T_NDB, scramb),
                two_log_chan=True)
            records.append(SlotRecord(time.copy(), kind,
                                      dict(ndb1=ndb1, aach=aach, ndb2=ndb2)))
            out.append(b)
            continue
        if is_bsch(time):
            sb1 = build_sync_pdu(cfg.cc, time, cfg.mcc, cfg.mnc)
            # encrypted cells alternate the SYSINFO 17-bit arm between
            # hyperframe number and CCK id (odd multiframes carry the key id)
            alt_cck = (crypto is not None and crypto.cck is not None
                       and time.mn % 2 == 1)
            sb2 = build_sysinfo_pdu(cfg.main_carrier, cfg.freq_band,
                                    cfg.hyperframe, cfg.la,
                                    cfg.bs_service_details,
                                    cck_id=(crypto.cck_id if alt_cck
                                            else None))
            b = burst_mod.build_sync_burst(
                fec_enc.encode_block(sb1, P.TPSAP_T_SB1, scramb),
                bbk5,
                fec_enc.encode_block(sb2, P.TPSAP_T_SB2, scramb))
            records.append(SlotRecord(time.copy(), "sync",
                                      dict(sb1=sb1, aach=aach, sb2=sb2)))
        else:
            ndb1 = build_null_pdu()
            # TM-SDU = LLC BL-UDATA carrying a CMCE D-SDS-DATA payload
            payload = payload_rng.integers(0, 2, 65).astype(np.uint8)
            sdu = np.concatenate([
                _uint_to_bits(2, 4),    # LLC: BL-UDATA
                _uint_to_bits(2, 3),    # MLE pdisc: CMCE
                _uint_to_bits(0x0F, 5),  # CMCE: D-SDS DATA
                payload])
            ndb2 = build_resource_pdu(ssi=0x123456, sdu_bits=sdu,
                                      crypto=crypto, time=time)
            b = burst_mod.build_norm_burst(
                fec_enc.encode_block(ndb1, P.TPSAP_T_NDB, scramb),
                bbk5,
                fec_enc.encode_block(ndb2, P.TPSAP_T_NDB, scramb),
                two_log_chan=True)
            records.append(SlotRecord(time.copy(), "ndb",
                                      dict(ndb1=ndb1, aach=aach, ndb2=ndb2,
                                           sdu=sdu)))
        out.append(b)
    return np.concatenate(out), records
