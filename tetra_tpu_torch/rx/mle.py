"""MLE layer and CMCE/MM/SNDCP PDU identification (TL-SDU handling).

Parity-plus with tetra_mle.c / tetra_cmce_pdu.c / tetra_mm_pdu.c /
tetra_sndcp_pdu.c: the reference only maps PDU types to names in commented
printf debugging; here `rx_tl_sdu` returns a structured summary (protocol
discriminator, PDU name, and the SNDCP IP header fields the reference
extracts) that the upper MAC logs as events.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mac_pdu import BitReader

# Protocol discriminators (tetra_mle_pdu.h:26-33)
PDISC_MM = 1
PDISC_CMCE = 2
PDISC_SNDCP = 4
PDISC_MLE = 5
PDISC_MGMT = 6
PDISC_TEST = 7

PDISC_NAMES = {
    PDISC_MM: "MM", PDISC_CMCE: "CMCE", PDISC_SNDCP: "SNDCP",
    PDISC_MLE: "MLE", PDISC_MGMT: "MGMT", PDISC_TEST: "TEST",
}

MM_PDU_NAMES = {
    0x0: "D-OTAR", 0x1: "D-AUTHENTICATION", 0x2: "D-CK CHANGE DEMAND",
    0x3: "D-DISABLE", 0x4: "D-ENABLE", 0x5: "D-LOCATION UPDATE ACCEPT",
    0x6: "D-LOCATION UPDATE COMMAND", 0x7: "D-LOCATION UPDATE REJECT",
    0x9: "D-LOCATION UPDATE PROCEEDING", 0xA: "D-ATTACH/DETACH GROUP ID",
    0xB: "D-ATTACH/DETACH GROUP ID ACK", 0xC: "D-MM STATUS",
    0xF: "D-MM PDU NOT SUPPORTED",
}

CMCE_PDU_NAMES = {
    0x00: "D-ALERT", 0x01: "D-CALL PROCEEDING", 0x02: "D-CONNECT",
    0x03: "D-CONNECT ACK", 0x04: "D-DISCONNECT", 0x05: "D-INFO",
    0x06: "D-RELEASE", 0x07: "D-SETUP", 0x08: "D-STATUS",
    0x09: "D-TX CEASED", 0x0A: "D-TX CONTINUE", 0x0B: "D-TX GRANTED",
    0x0C: "D-TX WAIT", 0x0D: "D-TX INTERRUPT", 0x0E: "D-CALL RESTORE",
    0x0F: "D-SDS DATA", 0x10: "D-FACILITY",
}

SNDCP_PDU_NAMES = {
    0: "SN-ACTIVATE PDP ACCEPT", 1: "SN-DEACTIVATE PDP ACCEPT",
    2: "SN-DEACTIVATE PDP DEMAND", 3: "SN-ACTIVATE PDP REJECT",
    4: "SN-UNITDATA", 5: "SN-DATA", 6: "SN-DATA TX REQUEST",
    7: "SN-DATA TX RESPONSE", 8: "SN-END OF DATA", 9: "SN-RECONNECT",
    10: "SN-PAGE REQUEST", 11: "SN-NOT SUPPORTED", 12: "SN-DATA PRIORITY",
    13: "SN-MODIFY",
}

MLE_PDU_NAMES = {
    0: "D-NEW CELL", 1: "D-PREPARE FAIL", 2: "D-NWRK BROADCAST",
    3: "D-NWRK BROADCAST EXT", 4: "D-RESTORE ACK", 5: "D-RESTORE FAIL",
    6: "D-CHANNEL RESPONSE",
}


@dataclass
class TlSdu:
    pdisc: int = -1
    pdisc_name: str = "?"
    pdu_name: str = "?"
    # SNDCP extras (fields the reference pulls, tetra_mle.c:35-45)
    nsapi: int | None = None
    pcomp: int | None = None
    dcomp: int | None = None
    ip_version: int | None = None
    ip_proto: int | None = None


def rx_tl_sdu(bits: np.ndarray) -> TlSdu:
    """Identify one TL-SDU (LLC SDU == MLE PDU)."""
    bits = np.asarray(bits, np.uint8)
    out = TlSdu()
    if len(bits) < 3:
        return out
    r = BitReader(bits)
    out.pdisc = r.peek(0, 3)
    out.pdisc_name = PDISC_NAMES.get(out.pdisc, f"?{out.pdisc}")
    if out.pdisc == PDISC_MM and len(bits) >= 7:
        out.pdu_name = MM_PDU_NAMES.get(r.peek(3, 4), "?")
    elif out.pdisc == PDISC_CMCE and len(bits) >= 8:
        out.pdu_name = CMCE_PDU_NAMES.get(r.peek(3, 5), "?")
    elif out.pdisc == PDISC_SNDCP and len(bits) >= 7:
        out.pdu_name = SNDCP_PDU_NAMES.get(r.peek(3, 4), "?")
        if len(bits) >= 3 + 4 + 4 + 4 + 4 + 4:
            out.nsapi = r.peek(7, 4)
            out.pcomp = r.peek(11, 4)
            out.dcomp = r.peek(15, 4)
            out.ip_version = r.peek(19, 4)
        if len(bits) >= 3 + 4 + 4 + 4 + 4 + 4 + 64 + 8:
            out.ip_proto = r.peek(3 + 4 + 4 + 4 + 4 + 4 + 64, 8)
    elif out.pdisc == PDISC_MLE and len(bits) >= 6:
        out.pdu_name = MLE_PDU_NAMES.get(r.peek(3, 3), "?")
    return out
