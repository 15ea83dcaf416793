"""LLC PDU parsing (EN 300 392-2 clause 21 tables 21.1-21.26).

The reference carries a full LLC parser but ships it disabled (renamed
tetra_llc_pdu.coff, call sites commented "TODO: fix llc"; SURVEY.md section
2.6).  This framework enables the layer: basic-link (BL-*) PDUs with optional
32-bit FCS, advanced-link (AL-*) data/final/udata/ufinal with segment
numbers, and the bit-level CRC-32 FCS with the short-block shift behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mac_pdu import BitReader

# Table 21.1
PDUT_BL_ADATA = 0
PDUT_BL_DATA = 1
PDUT_BL_UDATA = 2
PDUT_BL_ACK = 3
PDUT_BL_ADATA_FCS = 4
PDUT_BL_DATA_FCS = 5
PDUT_BL_UDATA_FCS = 6
PDUT_BL_ACK_FCS = 7
PDUT_AL_SETUP = 8
PDUT_AL_DATA_FINAL = 9
PDUT_AL_UDATA_UFINAL = 10
PDUT_AL_ACK_RNR = 11
PDUT_AL_RECONNECT = 12
PDUT_SUPPL = 13
PDUT_L2SIG = 14
PDUT_AL_DISC = 15

PDU_NAMES = {
    PDUT_BL_ADATA: "BL-ADATA", PDUT_BL_DATA: "BL-DATA",
    PDUT_BL_UDATA: "BL-UDATA", PDUT_BL_ACK: "BL-ACK",
    PDUT_BL_ADATA_FCS: "BL-ADATA-FCS", PDUT_BL_DATA_FCS: "BL-DATA-FCS",
    PDUT_BL_UDATA_FCS: "BL-UDATA-FCS", PDUT_BL_ACK_FCS: "BL-ACK-FCS",
    PDUT_AL_SETUP: "AL-SETUP", PDUT_AL_DATA_FINAL: "AL-DATA/FINAL",
    PDUT_AL_UDATA_UFINAL: "AL-UDATA/UFINAL", PDUT_AL_ACK_RNR: "AL-ACK/RNR",
    PDUT_AL_RECONNECT: "AL-RECONNECT", PDUT_SUPPL: "AL-SUPPLEMENTARY",
    PDUT_L2SIG: "AL-L2SIG", PDUT_AL_DISC: "AL-DISC",
}

# minimum header bits per PDU type (tetra_llc_pdu.coff:88-105)
_MIN_LEN = {
    PDUT_BL_ADATA: 6, PDUT_BL_DATA: 5, PDUT_BL_UDATA: 4, PDUT_BL_ACK: 5,
    PDUT_BL_ADATA_FCS: 38, PDUT_BL_DATA_FCS: 37, PDUT_BL_UDATA_FCS: 36,
    PDUT_BL_ACK_FCS: 37, PDUT_AL_DATA_FINAL: 13, PDUT_AL_UDATA_UFINAL: 17,
    PDUT_AL_ACK_RNR: 1,
}


def llc_fcs(bits: np.ndarray) -> int:
    """Bitwise CRC-32 (poly 0x04C11DB7, init all-ones, complemented), with
    the short-block register pre-shift of tetra_llc_pdu.coff:110-125."""
    crc = 0xFFFFFFFF
    n = len(bits)
    if n < 32:
        crc = (crc << (32 - n)) & 0xFFFFFFFF
    for b in bits:
        bit = (int(b) ^ (crc >> 31)) & 1
        crc = (crc << 1) & 0xFFFFFFFF
        if bit:
            crc ^= 0x04C11DB7
    return crc ^ 0xFFFFFFFF


@dataclass
class LlcPdu:
    pdu_type: int = -1
    name: str = "UNKNOWN"
    nr: int = 0
    ns: int = 0
    ss: int = 0
    have_fcs: bool = False
    fcs: int = 0
    fcs_ok: bool = True
    final: bool = False
    tl_sdu: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))


def parse_llc(bits: np.ndarray) -> LlcPdu:
    """Parse one LLC PDU from a TM-SDU bit array."""
    bits = np.asarray(bits, np.uint8)
    out = LlcPdu()
    if len(bits) < 4:
        return out
    r = BitReader(bits)
    pdu_type = r.peek(0, 4)
    out.pdu_type = pdu_type
    out.name = PDU_NAMES.get(pdu_type, "UNKNOWN")
    if len(bits) < _MIN_LEN.get(pdu_type, 4):
        return out
    pos = 4

    def take(n):
        nonlocal pos
        v = r.peek(pos, n)
        pos += n
        return v

    def finish_sdu(with_fcs: bool):
        sdu = bits[pos:]
        if with_fcs:
            out.have_fcs = True
            out.fcs = r.peek(len(bits) - 32, 32)
            sdu = sdu[:-32]
            out.fcs_ok = llc_fcs(sdu) == out.fcs
        out.tl_sdu = sdu

    if pdu_type in (PDUT_BL_ADATA, PDUT_BL_ADATA_FCS):
        out.nr = take(1)
        out.ns = take(1)
        finish_sdu(pdu_type == PDUT_BL_ADATA_FCS)
    elif pdu_type in (PDUT_BL_DATA, PDUT_BL_DATA_FCS):
        out.ns = take(1)
        finish_sdu(pdu_type == PDUT_BL_DATA_FCS)
    elif pdu_type in (PDUT_BL_UDATA, PDUT_BL_UDATA_FCS):
        finish_sdu(pdu_type == PDUT_BL_UDATA_FCS)
    elif pdu_type in (PDUT_BL_ACK, PDUT_BL_ACK_FCS):
        out.nr = take(1)
        finish_sdu(pdu_type == PDUT_BL_ACK_FCS)
    elif pdu_type == PDUT_AL_DATA_FINAL:
        out.final = bool(take(1))
        take(1)  # AR flag / reserved
        out.ns = take(3)
        out.ss = take(8)
        out.tl_sdu = bits[pos:]
        out.have_fcs = out.final  # FCS checked after reassembly
    elif pdu_type == PDUT_AL_UDATA_UFINAL:
        out.final = bool(take(1))
        out.ns = take(8)
        out.ss = take(8)
        out.tl_sdu = bits[pos:]
        out.have_fcs = out.final
    elif pdu_type == PDUT_AL_ACK_RNR:
        out.final = bool(take(1))  # 1 = ACK, 0 = RNR
    # AL-SETUP / RECONNECT / DISC / SUPPL / L2SIG: recognized, no payload
    return out
