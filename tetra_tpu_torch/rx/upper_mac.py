"""Upper MAC: TMV-SAP dispatch, broadcast decoding, resources, fragments
(port of tetra_tpu/rx/upper_mac.py, host NumPy, with its air-interface
decryption hooks: set crypto_state to a crypto.state.CryptoState).

Host-side re-design of tetra_upper_mac.c: the device FEC pipeline delivers
decoded type-1 bit arrays; this layer routes them by logical channel and PDU
type, maintains MAC state (traffic flags, fragment slots, SYSINFO-derived
cell info), and writes the DisplayState metrics bus.

Fragment reassembly follows tetra_upper_mac.c:41-73, 314-430 (5 slots, aged
out after N203=6 multiframes on fn==18).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import mac_pdu as p
from .display import DisplayState
from .llc import parse_llc
from .mle import rx_tl_sdu
from .tdma import TdmaTime

# Logical channels (tetra_common.h enum tetra_log_chan)
LC_UNKNOWN = 0
LC_SCH_F = 1
LC_AACH = 8
LC_BSCH = 10
LC_BNCH = 11

N203 = 6
FRAGSLOT_NR_SLOTS = 5
REASSEMBLE_FRAGMENTS = True

_NATIVE_MAC_MOD = None


def _nm():
    global _NATIVE_MAC_MOD
    if _NATIVE_MAC_MOD is None:
        from . import native_mac
        _NATIVE_MAC_MOD = native_mac
    return _NATIVE_MAC_MOD


@dataclass
class FragSlot:
    active: bool = False
    age: int = 0
    num_frags: int = 0
    length: int = 0
    encryption: bool = False
    key: object = None
    bits: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))


def _num_fill_bits(bits: np.ndarray) -> int:
    """Fill bits run backwards from the end until the marker 1 bit
    (get_num_fill_bits, tetra_upper_mac.c:75-83)."""
    n = len(bits)
    for i in range(1, n):
        if bits[n - i] == 1:
            return i
    return 0


@dataclass
class UpperMac:
    display: DisplayState = field(default_factory=DisplayState)
    crypto_state: object = None  # crypto.state.CryptoState | None
    fragslots: list[FragSlot] = field(
        default_factory=lambda: [FragSlot() for _ in range(FRAGSLOT_NR_SLOTS)])
    # mirrors of tetra_mac_state
    is_traffic: int = 0
    blk1_stolen: bool = False
    blk2_stolen: bool = False
    ssi: int = 0
    usage_marker: int = 0
    addr_type: int = 0
    last_sysinfo: p.SysinfoPdu | None = None
    # log of parsed PDUs (for apps/tests).  events_enabled=False skips both
    # the appends and the LLC/MLE identification work whose only output is
    # the event log -- the production no-consumer setting (the CLI enables
    # it for -v); the list otherwise grows unboundedly in long runs.
    events: list = field(default_factory=list)
    events_enabled: bool = True

    # -- fragment bookkeeping ------------------------------------------------

    def _age_fragslots(self):
        for fs in self.fragslots:
            if fs.active:
                fs.age += 1
                if fs.age > N203:
                    fs.__init__()

    # -- per-PDU handlers ----------------------------------------------------

    def _rx_bcast(self, bits: np.ndarray, time: TdmaTime):
        sid = p.decode_sysinfo(bits)
        self.last_sysinfo = sid
        d = self.display
        d.dl_freq = sid.dl_freq_hz
        d.ul_freq = sid.ul_freq_hz
        if not sid.cck_valid_no_hf:
            d.curr_hyperframe = sid.hyperframe_number
        for i, name in enumerate(p.BS_SERVICE_FLAGS):
            if name is not None:
                setattr(d, name, bool(sid.bs_service_details & (1 << i)))
        if self.crypto_state is not None:
            self.crypto_state.update_from_sysinfo(sid)
        if self.events_enabled:
            self.events.append(("sysinfo", time.copy(), sid))
        return -1

    def _rx_resrc(self, bits: np.ndarray, time: TdmaTime):
        rsd, tmpdu_offset = p.decode_resource(bits)
        if rsd.macpdu_length == p.MACPDU_LEN_2ND_STOLEN:
            pdu_bits = -1
            self.blk2_stolen = True
        elif rsd.macpdu_length == p.MACPDU_LEN_START_FRAG:
            pdu_bits = -1
        elif rsd.macpdu_length is None:
            pdu_bits = -1
        else:
            pdu_bits = rsd.macpdu_length * 8
            bits = bits[:pdu_bits]
        if rsd.fill_bits:
            nf = _num_fill_bits(bits)
            bits = bits[:len(bits) - nf]
        # encrypted payload decryption hooks in here (crypto module); the
        # keystore-less path matches the reference default (keystore never
        # loaded by the plugin, SURVEY.md section 2.7)
        if self.crypto_state is not None and rsd.is_encrypted:
            dec = self.crypto_state.try_decrypt_mac_element(
                bits, time, tmpdu_offset)
            if dec is not None:
                bits = dec
                rsd.is_encrypted = False
                if rsd.chan_alloc_pres:
                    cad, used = p.decode_chan_alloc(bits, tmpdu_offset)
                    rsd.cad = cad
                    tmpdu_offset += used
        if self.events_enabled:
            self.events.append(("resource", time.copy(), rsd))
        if rsd.addr.type == p.ADDR_TYPE_NULL:
            return -1
        self.ssi = rsd.addr.ssi
        self.usage_marker = rsd.addr.usage_marker
        self.addr_type = rsd.addr.type
        sdu = bits[tmpdu_offset:]
        if len(sdu) == 0 or rsd.is_encrypted:
            return pdu_bits
        if rsd.macpdu_length == p.MACPDU_LEN_START_FRAG and REASSEMBLE_FRAGMENTS:
            slot = time.tn
            fs = self.fragslots[slot % FRAGSLOT_NR_SLOTS]
            fs.__init__()
            fs.active = True
            fs.num_frags = 1
            fs.length = len(sdu)
            fs.encryption = rsd.encryption_mode > 0
            fs.bits = np.array(sdu, np.uint8)
        else:
            if self.events_enabled:
                self.events.append(("tm_sdu", time.copy(), np.array(sdu)))
            self._rx_tm_sdu(sdu, time)
        return pdu_bits

    def _rx_tm_sdu(self, sdu: np.ndarray, time: TdmaTime):
        """LLC + MLE identification of a TM-SDU (the layer the reference
        ships disabled: tetra_llc_pdu.coff + rx_tl_sdu, tetra_mle.c:20-53)."""
        if not self.events_enabled:
            return  # identification feeds only the event log
        llc = parse_llc(sdu)
        tl = rx_tl_sdu(llc.tl_sdu) if len(llc.tl_sdu) else None
        self.events.append(("llc", time.copy(), llc, tl))

    def _rx_macfrag(self, bits: np.ndarray, time: TdmaTime):
        slot = time.tn
        fs = self.fragslots[slot % FRAGSLOT_NR_SLOTS]
        if not fs.active:
            return -1
        n = 2 + 1  # MAC-FRAG/END (01) + MAC-FRAG (0)
        fill = p.bits_to_uint(bits, n, 1)
        n += 1
        payload = bits
        if fill:
            payload = payload[:len(payload) - _num_fill_bits(payload)]
        frag = payload[n:]
        fs.bits = np.concatenate([fs.bits, frag])
        fs.length += len(frag)
        fs.num_frags += 1
        fs.age = 0
        return -1

    def _rx_macend(self, bits: np.ndarray, time: TdmaTime):
        slot = time.tn
        fs = self.fragslots[slot % FRAGSLOT_NR_SLOTS]
        r = p.BitReader(bits, 2)
        r.skip(1)  # MAC-END (1)
        fill = r.take(1)
        r.skip(1)  # position of grant
        length_indicator = r.take(6)
        if fs.active:
            slot_granting = r.take(1)
            if slot_granting:
                r.skip(8)
            chanalloc_present = r.take(1)
            payload = bits[:length_indicator * 8]
            if fill:
                payload = payload[:len(payload) - _num_fill_bits(payload)]
            if chanalloc_present:
                _, used = p.decode_chan_alloc(bits, r.pos)
                r.skip(used)
            frag = payload[r.pos:]
            fs.bits = np.concatenate([fs.bits, frag])
            fs.length += len(frag)
            if self.events_enabled:
                self.events.append(("tm_sdu_reassembled", time.copy(),
                                    fs.bits.copy()))
            self._rx_tm_sdu(fs.bits.copy(), time)
        fs.__init__()
        return length_indicator * 8

    def _rx_suppl(self, bits: np.ndarray, time: TdmaTime):
        # minimal D-BLCK handling (tetra_upper_mac.c:433-462)
        slot_granting = bits[17] if len(bits) > 17 else 0
        tmpdu_offset = 17 + 1 + (8 if slot_granting else 0)
        if self.events_enabled:
            self.events.append(("suppl", time.copy(), bits[tmpdu_offset:]))
        return -1

    def _rx_aach(self, bits: np.ndarray, time: TdmaTime):
        aad = p.decode_access_assign(bits, frame18=(time.fn == 18))
        d = self.display
        if aad.access1 is not None:
            d.access1_code = chr(ord("A") + aad.access1[0])
            d.access1 = aad.access1[1]
        if aad.access2 is not None:
            d.access2_code = chr(ord("A") + aad.access2[0])
            d.access2 = aad.access2[1]
        if aad.dl_usage is not None:
            d.dl_usage = aad.dl_usage
        if aad.ul_usage is not None:
            d.ul_usage = aad.ul_usage
        self.is_traffic = aad.dl_usage if (aad.dl_usage or 0) > 3 else 0
        self.blk1_stolen = False
        self.blk2_stolen = False
        if self.events_enabled:
            self.events.append(("aach", time.copy(), aad))

    # -- TMV-SAP entry (rx_tmv_unitdata_ind + the lower-MAC PDU loop) --------

    def _native_handle(self):
        """Native receive core (rx/native/macparse.cpp), created lazily the
        first time the fast-path preconditions hold."""
        h = self.__dict__.get("_native")
        if h is None:
            from . import native_mac
            lib = native_mac.load()
            h = (native_mac.NativeMacHandle(lib) if lib is not None
                 else False)
            self.__dict__["_native"] = h
        return h

    def _sync_native(self, h, flags):
        """Pull the scalar MAC state + any display-field changes out of the
        native core after a receive call.  AACH/SYSINFO display updates are
        change-gated by the packed `seen` bits so the common case costs a
        few integer ops."""
        nm = _nm()
        self.is_traffic = flags & 0xFF
        self.blk1_stolen = bool(flags & 0x100)
        self.blk2_stolen = bool(flags & 0x200)
        self.addr_type = (flags >> 10) & 7
        self.usage_marker = (flags >> 13) & 0x3F
        self.ssi = (flags >> 32) & 0xFFFFFF
        if not (flags & 0x300000):      # no AACH / SYSINFO this block
            return
        d = self.display
        if flags & nm.F_AACH_SEEN:
            a = h.st.aach
            if a.have1:
                d.access1_code = chr(ord("A") + a.code1)
                d.access1 = a.val1
            if a.have2:
                d.access2_code = chr(ord("A") + a.code2)
                d.access2 = a.val2
            if a.have_dl:
                d.dl_usage = a.dl
            if a.have_ul:
                d.ul_usage = a.ul
        if flags & nm.F_SI_SEEN:
            s = h.st.si
            sid = p.SysinfoPdu(
                **{n: getattr(s, n) for n in nm.SYSINFO_FIELDS})
            self.last_sysinfo = sid
            d.dl_freq = s.dl_freq
            d.ul_freq = s.ul_freq
            if not s.cck_valid_no_hf:
                d.curr_hyperframe = s.hyperframe_number
            for i, name in enumerate(p.BS_SERVICE_FLAGS):
                if name is not None:
                    setattr(d, name, bool(s.bs_service_details & (1 << i)))

    def receive(self, type1: np.ndarray, lchan: int, crc_ok: bool,
                time: TdmaTime):
        """Process one decoded type-1 block: iterate MAC PDUs within it
        (the while-loop of tetra_lower_mac.c:383-405)."""
        if not crc_ok:
            return
        if not self.events_enabled and self.crypto_state is None:
            h = self._native_handle()
            if h is not False:
                b = type1
                if b.dtype != np.uint8 or not b.flags["C_CONTIGUOUS"]:
                    b = np.ascontiguousarray(b, np.uint8)
                fin = ((self.is_traffic & 0xFF)
                       | (0x100 if self.blk1_stolen else 0)
                       | (0x200 if self.blk2_stolen else 0))
                flags = h.receive(b.ctypes.data, len(b), lchan,
                                  time.tn, time.fn, fin)
                self._sync_native(h, flags)
                return
        if time.fn == 18 and REASSEMBLE_FRAGMENTS:
            self._age_fragslots()
        if lchan == LC_AACH:
            self._rx_aach(type1, time)
            return
        if lchan == LC_BSCH:
            return  # SYNC PDU handled by the lower MAC (cell time/scrambling)
        total = len(type1)
        offset = 0
        while offset < total - 16:
            bits = type1[offset:]
            pdu_type = p.bits_to_uint(bits, 0, 2)
            if pdu_type == p.PDU_T_BROADCAST:
                n = self._rx_bcast(bits, time)
            elif pdu_type == p.PDU_T_MAC_RESOURCE:
                n = self._rx_resrc(bits, time)
            elif pdu_type == p.PDU_T_MAC_SUPPL:
                n = self._rx_suppl(bits, time)
            elif pdu_type == p.PDU_T_MAC_FRAG_END:
                if bits[2] == p.MAC_FRAGE_FRAG:
                    n = self._rx_macfrag(bits, time)
                else:
                    n = self._rx_macend(bits, time)
            else:
                n = -1
            if n is None or n < 0:
                break
            offset += n
