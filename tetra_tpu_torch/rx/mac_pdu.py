"""MAC PDU field decoders (EN 300 392-2 clause 21), host side.

Capability-parity with tetra_mac_pdu.c: SYSINFO (21.4.4.1), channel
allocation (21.5.2 incl. extended carrier + augmented fields), MAC-RESOURCE
(21.4.3.1), ACCESS-ASSIGN (21.4.7.2), plus carrier-frequency computation
(tetra_common.c:124-174, TS 100 392-15 table 2 duplex spacings).

PDU parsing is branchy, variable-length bit logic at ~kHz rates - it stays on
the host per SURVEY.md section 7 step 5; only fixed-shape FEC runs on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# MAC PDU types (21.4.1)
PDU_T_MAC_RESOURCE = 0
PDU_T_MAC_FRAG_END = 1
PDU_T_BROADCAST = 2
PDU_T_MAC_SUPPL = 3

MAC_FRAGE_FRAG = 0
MAC_FRAGE_END = 1

# Address types (21.4.3.1)
ADDR_TYPE_NULL = 0
ADDR_TYPE_SSI = 1
ADDR_TYPE_EVENT_LABEL = 2
ADDR_TYPE_USSI = 3
ADDR_TYPE_SMI = 4
ADDR_TYPE_SSI_EVENT = 5
ADDR_TYPE_SSI_USAGE = 6
ADDR_TYPE_SMI_EVENT = 7

_ADDR_LEN = {
    ADDR_TYPE_SSI: 24, ADDR_TYPE_EVENT_LABEL: 10, ADDR_TYPE_USSI: 24,
    ADDR_TYPE_SMI: 24, ADDR_TYPE_SSI_EVENT: 34, ADDR_TYPE_SSI_USAGE: 30,
    ADDR_TYPE_SMI_EVENT: 34,
}

# macpdu_length sentinel values
MACPDU_LEN_2ND_STOLEN = -2
MACPDU_LEN_START_FRAG = -1

# BS service detail flag bits (display order of tetra_upper_mac.c:118-168)
BS_SERVICE_FLAGS = (
    "advanced_link", "air_encryption", "sndcp_data", None, "circuit_data",
    "voice_service", "normal_mode", "migration_supported",
    "never_minimum_mode", "priority_cell", "dereg_mandatory", "reg_mandatory",
)


_POW2_I64 = (1 << np.arange(62, -1, -1)).astype(np.int64)


def bits_to_uint(bits: np.ndarray, start: int, length: int) -> int:
    """MSB-first bit-array to integer (tetra_common.c:114-122) - the hottest
    host-path primitive (hundreds of calls per slot).  A shift-accumulate
    over .tolist() beats both np.dot and np.packbits by 2-4x at the PDU
    field sizes (2..24 bits): the numpy per-call dispatch overhead dwarfs
    the arithmetic at these lengths."""
    v = 0
    for b in bits[start:start + length].tolist():
        v = (v << 1) | b
    return v


class BitReader:
    """Sequential MSB-first reader over a bit-per-byte array.

    Packs the whole array into one Python int up front (np.packbits is a
    single C call); each field read is then a shift+mask -- ~10x cheaper
    than per-field slice+accumulate at PDU field sizes, which dominates the
    host profile at 100+ channels.  Reads past the end clip to the
    available bits (same semantics as bits_to_uint's slice)."""

    __slots__ = ("bits", "pos", "_big", "_shift")

    def __init__(self, bits: np.ndarray, pos: int = 0):
        self.bits = np.asarray(bits, np.uint8)
        self.pos = pos
        self._shift = ((len(self.bits) + 7) // 8) * 8
        self._big = int.from_bytes(np.packbits(self.bits).tobytes(), "big")

    def peek(self, pos: int, n: int) -> int:
        end = pos + n
        L = len(self.bits)
        if end > L:
            end = L
        if end <= pos:
            return 0
        return (self._big >> (self._shift - end)) & ((1 << (end - pos)) - 1)

    def take(self, n: int) -> int:
        v = self.peek(self.pos, n)
        self.pos += n
        return v

    def skip(self, n: int):
        self.pos += n

    @property
    def remaining(self) -> int:
        return len(self.bits) - self.pos


# ---------------------------------------------------------------------------
# Carrier frequency (tetra_common.c:124-174)
# ---------------------------------------------------------------------------

_CARRIER_OFFSET_HZ = (0, 6250, -6250, 12500)

# TS 100 392-15 Table 2, kHz; -1 = reserved
_DUPLEX_SPACING_KHZ = (
    (-1, 1600, 10000, 10000, 10000, 10000, 10000, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (-1, 4500, -1, 36000, 7000, -1, -1, -1, 45000, 45000, -1, -1, -1, -1, -1, -1),
    (0,) * 16,
    (-1, -1, -1, 8000, 8000, -1, -1, -1, 18000, 18000, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, 18000, 5000, -1, 30000, 30000, -1, 39000, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, -1, 9500, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (-1,) * 16,
    (-1,) * 16,
)


def dl_carrier_hz(band: int, carrier: int, offset: int) -> int:
    return band * 100_000_000 + carrier * 25_000 + _CARRIER_OFFSET_HZ[offset & 3]


def ul_carrier_hz(band: int, carrier: int, offset: int, duplex: int,
                  reverse: int) -> int:
    freq = dl_carrier_hz(band, carrier, offset)
    spacing = _DUPLEX_SPACING_KHZ[duplex & 7][band & 15]
    if spacing < 0:
        return 0
    return freq + spacing * 1000 if reverse else freq - spacing * 1000


# ---------------------------------------------------------------------------
# SYNC PDU (BSCH, parsed inline in the lower MAC per tetra_lower_mac.c:246-276)
# ---------------------------------------------------------------------------


@dataclass
class SyncPdu:
    colour_code: int = 0
    tn: int = 1
    fn: int = 1
    mn: int = 1
    sharing_mode: int = 0
    ts_reserved_frames: int = 0
    u_plane_dtx: int = 0
    frame_18_ext: int = 0
    mcc: int = 0
    mnc: int = 0


def decode_sync_pdu(bits: np.ndarray) -> SyncPdu:
    """SYNC PDU from SB1 type-1 bits (21.4.4.2 layout)."""
    r = BitReader(bits)
    r.skip(4)  # system code
    s = SyncPdu()
    s.colour_code = r.take(6)
    s.tn = r.take(2) + 1
    s.fn = r.take(5)
    s.mn = r.take(6)
    s.sharing_mode = r.take(2)
    s.ts_reserved_frames = r.take(3)
    s.u_plane_dtx = r.take(1)
    s.frame_18_ext = r.take(1)
    s.mcc = r.peek(31, 10)
    s.mnc = r.peek(41, 14)
    return s


# ---------------------------------------------------------------------------
# SYSINFO / D-MLE-SYSINFO (21.4.4.1)
# ---------------------------------------------------------------------------


@dataclass
class SysinfoPdu:
    main_carrier: int = 0
    freq_band: int = 0
    freq_offset: int = 0
    duplex_spacing: int = 0
    reverse_operation: int = 0
    num_of_csch: int = 0
    ms_txpwr_max_cell: int = 0
    rxlev_access_min: int = 0
    access_parameter: int = 0
    radio_dl_timeout: int = 0
    cck_valid_no_hf: int = 0
    cck_id: int = 0
    hyperframe_number: int = 0
    option_field: int = 0
    frame_bitmap: int = 0
    access_code: int = 0
    ext_service: int = 0
    # D-MLE-SYSINFO part
    la: int = 0
    subscr_class: int = 0
    bs_service_details: int = 0

    @property
    def dl_freq_hz(self) -> int:
        return dl_carrier_hz(self.freq_band, self.main_carrier, self.freq_offset)

    @property
    def ul_freq_hz(self) -> int:
        return ul_carrier_hz(self.freq_band, self.main_carrier,
                             self.freq_offset, self.duplex_spacing,
                             self.reverse_operation)


def decode_sysinfo(bits: np.ndarray) -> SysinfoPdu:
    r = BitReader(bits)
    r.skip(2)  # broadcast PDU header
    r.skip(2)  # sysinfo PDU subtype
    s = SysinfoPdu()
    s.main_carrier = r.take(12)
    s.freq_band = r.take(4)
    s.freq_offset = r.take(2)
    s.duplex_spacing = r.take(3)
    s.reverse_operation = r.take(1)
    s.num_of_csch = r.take(2)
    s.ms_txpwr_max_cell = r.take(3)
    s.rxlev_access_min = r.take(4)
    s.access_parameter = r.take(4)
    s.radio_dl_timeout = r.take(4)
    s.cck_valid_no_hf = r.take(1)
    if s.cck_valid_no_hf:
        s.cck_id = r.take(16)
    else:
        s.hyperframe_number = r.take(16)
    s.option_field = r.take(2)
    if s.option_field == 0 or s.option_field == 1:
        s.frame_bitmap = r.take(20)
    elif s.option_field == 2:
        s.access_code = r.take(20)
    else:
        s.ext_service = r.take(20)
    # D-MLE-SYSINFO at fixed offset 124-42 (tetra_mac_pdu.c:80)
    mr = BitReader(bits, 124 - 42)
    s.la = mr.take(14)
    s.subscr_class = mr.take(16)
    s.bs_service_details = mr.take(12)
    return s


# ---------------------------------------------------------------------------
# Channel allocation (21.5.2)
# ---------------------------------------------------------------------------


@dataclass
class ChanAlloc:
    type: int = 0
    timeslot: int = 0
    ul_dl: int = 0
    clch_perm: int = 0
    cell_chg_f: int = 0
    carrier_nr: int = 0
    ext_carr_pres: int = 0
    ext_freq_band: int = 0
    ext_freq_offset: int = 0
    ext_duplex_spc: int = 0
    ext_reverse_oper: int = 0
    monit_pattern: int = 0
    monit_patt_f18: int = 0


def decode_chan_alloc(bits: np.ndarray, start: int) -> tuple[ChanAlloc, int]:
    """Returns (decoded, bits consumed)."""
    r = BitReader(bits, start)
    c = ChanAlloc()
    c.type = r.take(2)
    c.timeslot = r.take(4)
    c.ul_dl = r.take(2)
    c.clch_perm = r.take(1)
    c.cell_chg_f = r.take(1)
    c.carrier_nr = r.take(12)
    c.ext_carr_pres = r.take(1)
    if c.ext_carr_pres:
        c.ext_freq_band = r.take(4)
        c.ext_freq_offset = r.take(2)
        c.ext_duplex_spc = r.take(3)
        c.ext_reverse_oper = r.take(1)
    c.monit_pattern = r.take(2)
    if c.monit_pattern == 0:
        c.monit_patt_f18 = r.take(2)
    if c.ul_dl == 0:  # augmented channel allocation (QAM)
        r.skip(2 + 3 + 3 + 3 + 3 + 3 + 4 + 5)
        napping_sts = r.take(2)
        if napping_sts == 1:
            r.skip(11)
        r.skip(4)
        if r.take(1):
            r.skip(16)
        if r.take(1):
            r.skip(16)
        r.skip(1)
    return c, r.pos - start


# ---------------------------------------------------------------------------
# MAC-RESOURCE (21.4.3.1)
# ---------------------------------------------------------------------------

_NR_SLOTS_TBL = (0, 1, 2, 3, 4, 5, 6, 8, 10, 13, 17, 24, 34, 51, 68, 0xFF)


def decode_length(length_ind: int) -> int | None:
    """Table 21.89 length indicator (decode_length, tetra_mac_pdu.c:162-179)."""
    if length_ind in (0, 0x3B, 0x3C) or length_ind == 0x3D:
        return None
    if length_ind <= 0x12:
        return length_ind
    if length_ind <= 0x3A:
        return 18 + (length_ind - 18)
    if length_ind == 0x3E:
        return MACPDU_LEN_2ND_STOLEN
    if length_ind == 0x3F:
        return MACPDU_LEN_START_FRAG
    return None


@dataclass
class Addr:
    type: int = ADDR_TYPE_NULL
    ssi: int = 0
    event_label: int = 0
    usage_marker: int = 0


@dataclass
class Resource:
    fill_bits: int = 0
    grant_position: int = 0
    encryption_mode: int = 0
    is_encrypted: bool = False
    rand_acc_flag: int = 0
    macpdu_length: int | None = None
    addr: Addr = field(default_factory=Addr)
    power_control_pres: int = 0
    slot_granting_pres: int = 0
    nr_slots: int = 0
    granting_delay: int = 0
    chan_alloc_pres: int = 0
    cad: ChanAlloc | None = None


def decode_resource(bits: np.ndarray, is_decrypted: bool = False
                    ) -> tuple[Resource, int]:
    """Returns (decoded, tm-sdu offset in bits)."""
    r = BitReader(bits, 2)
    d = Resource()
    d.fill_bits = r.take(1)
    d.grant_position = r.take(1)
    d.encryption_mode = r.take(2)
    d.is_encrypted = d.encryption_mode > 0 and not is_decrypted
    d.rand_acc_flag = r.take(1)
    d.macpdu_length = decode_length(r.take(6))
    d.addr.type = r.take(3)
    if d.addr.type == ADDR_TYPE_NULL:
        return d, 0
    if d.addr.type in (ADDR_TYPE_SSI, ADDR_TYPE_USSI, ADDR_TYPE_SMI):
        d.addr.ssi = r.peek(r.pos, 24)
    elif d.addr.type == ADDR_TYPE_EVENT_LABEL:
        d.addr.event_label = r.peek(r.pos, 10)
    elif d.addr.type in (ADDR_TYPE_SSI_EVENT, ADDR_TYPE_SMI_EVENT):
        d.addr.ssi = r.peek(r.pos, 24)
        d.addr.event_label = r.peek(r.pos + 24, 10)
    elif d.addr.type == ADDR_TYPE_SSI_USAGE:
        d.addr.ssi = r.peek(r.pos, 24)
        d.addr.usage_marker = r.peek(r.pos + 24, 6)
    r.skip(_ADDR_LEN[d.addr.type])
    d.power_control_pres = r.take(1)
    if d.power_control_pres:
        r.skip(4)
    d.slot_granting_pres = r.take(1)
    if d.slot_granting_pres:
        d.nr_slots = _NR_SLOTS_TBL[r.take(4)]
        d.granting_delay = r.take(4)
    d.chan_alloc_pres = r.take(1)
    if d.chan_alloc_pres and not d.is_encrypted:
        d.cad, used = decode_chan_alloc(bits, r.pos)
        r.skip(used)
    return d, r.pos


# ---------------------------------------------------------------------------
# ACCESS-ASSIGN (21.4.7.2)
# ---------------------------------------------------------------------------


@dataclass
class AccessAssign:
    hdr: int = 0
    access1: tuple[int, int] | None = None  # (access_code, base_frame_len)
    access2: tuple[int, int] | None = None
    dl_usage: int | None = None
    ul_usage: int | None = None


def decode_access_assign(bits: np.ndarray, frame18: bool) -> AccessAssign:
    a = AccessAssign()
    v = bits_to_uint(bits, 0, 14)   # one extraction for all three fields
    a.hdr = v >> 12
    f1 = (v >> 6) & 0x3F
    f2 = v & 0x3F
    acc = lambda f: ((f >> 4) & 3, f & 0xF)
    if not frame18:
        if a.hdr == 0:       # DL CC, UL CO
            a.access1, a.access2 = acc(f1), acc(f2)
        elif a.hdr in (1, 2):  # DL field1, UL CA / AO
            a.dl_usage, a.access2 = f1, acc(f2)
        else:                # DL field1, UL field1
            a.dl_usage, a.ul_usage = f1, f2
    else:
        if a.hdr in (0, 1, 2):
            a.access1, a.access2 = acc(f1), acc(f2)
        else:                # ULCA2: field1 = traffic usage marker
            a.access2 = acc(f2)
    return a
