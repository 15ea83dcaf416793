"""Air-interface encryption state: keystore, IV/TB5, keystream application.

Capability-parity with crypto/tetra_crypto.{c,h}: key database with the same
text keystore format, per-network KSG selection (TEA1-3), CCK/SCK selection by
cck_id, IV construction from TDMA time, TB5 ECK derivation, and keystream
application to MAC elements (with the 216-bit second-half-slot skip) and
voice timeslots.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..rx.tdma import TdmaTime
from . import tea

# key types (tetra_crypto.h)
KEYTYPE_CCK_SCK = 1
KEYTYPE_DCK = 2
KEYTYPE_MGCK = 3
KEYTYPE_GCK = 4

KSG_TEA1, KSG_TEA2, KSG_TEA3 = 1, 2, 3


@dataclass
class NetInfo:
    mcc: int
    mnc: int
    ksg_type: int
    security_class: int


@dataclass
class Key:
    mcc: int
    mnc: int
    addr: int
    key_type: int
    key_num: int
    key: bytes                     # 80-bit cipher key
    network: NetInfo | None = None


def build_iv(t: TdmaTime, hn: int, direction: int = 0) -> int:
    """29-bit IV from TDMA time (tea_build_iv, tetra_crypto.c:152-160)."""
    assert 1 <= t.tn <= 4 and 1 <= t.fn <= 18 and 1 <= t.mn <= 60
    return ((t.tn - 1) | (t.fn << 2) | (t.mn << 7)
            | ((hn & 0x7FFF) << 13) | ((direction & 1) << 28))


def tb5(cn: int, la: int, cc: int, ck: bytes) -> bytes:
    """ECK derivation: XOR the 80-bit CK with the packed
    [la:14 cn:12 cc:6 cn:12 cc:6 cn:12 cc:6 cn:12] mask (taa1.c:381-420)."""
    cn &= 0xFFF
    la &= 0x3FFF
    cc &= 0x3F
    # 80-bit mask [ la:14 | cn:12 | cc:6 | cn:12 | cc:6 | cn:12 | cc:6 | cn:12 ]
    mask = ((la << 66) | (cn << 54) | (cc << 48) | (cn << 36)
            | (cc << 30) | (cn << 18) | (cc << 12) | cn)
    ck_int = int.from_bytes(ck, "big")
    return (ck_int ^ mask).to_bytes(10, "big")


@dataclass
class KeyStore:
    nets: list[NetInfo] = field(default_factory=list)
    keys: list[Key] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "KeyStore":
        """Parse the reference-compatible text keystore
        (format documented at tetra_crypto.c:306-319)."""
        ks = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                tok = line.split()
                kv = dict(zip(tok[1::2], tok[2::2]))
                if tok[0] == "network":
                    ks.nets.append(NetInfo(
                        mcc=int(kv["mcc"]), mnc=int(kv["mnc"]),
                        ksg_type=int(kv["ksg_type"]),
                        security_class=int(kv["security_class"])))
                elif tok[0] == "key":
                    ks.keys.append(Key(
                        mcc=int(kv["mcc"]), mnc=int(kv["mnc"]),
                        addr=int(kv["addr"]), key_type=int(kv["key_type"]),
                        key_num=int(kv["key_num"]),
                        key=bytes.fromhex(kv["key"])))
                else:
                    raise ValueError(f"unparseable keystore line: {line}")
        for k in ks.keys:
            k.network = ks.network_info(k.mcc, k.mnc)
            if k.network is None:
                raise ValueError(f"no network info for key mcc={k.mcc} "
                                 f"mnc={k.mnc}")
        return ks

    def network_info(self, mcc: int, mnc: int) -> NetInfo | None:
        for n in self.nets:
            if n.mcc == mcc and n.mnc == mnc:
                return n
        return None


@dataclass
class CryptoState:
    """Mirror of struct tetra_crypto_state + the selection logic."""
    store: KeyStore = field(default_factory=KeyStore)
    mcc: int = -1
    mnc: int = -1
    hn: int = 0
    la: int = -1
    cn: int = -1
    cc: int = -1
    cck_id: int = -1
    network: NetInfo | None = None
    cck: Key | None = None

    # -- state updates driven by the MAC layers ------------------------------

    def update_network(self, mcc: int, mnc: int):
        """Called on SYNC PDU when the network changes
        (update_current_network, tetra_crypto.c:446-464)."""
        self.mcc, self.mnc = mcc, mnc
        self.network = self.store.network_info(mcc, mnc)
        self.update_cck()

    def update_cck(self):
        self.cck = None
        for k in self.store.keys:
            if (k.mcc == self.mcc and k.mnc == self.mnc
                    and k.key_num == self.cck_id
                    and k.key_type == KEYTYPE_CCK_SCK):
                self.cck = k
                break

    def update_from_sysinfo(self, sid):
        """SYSINFO updates la/cn and CCK selection (rx_bcast,
        tetra_upper_mac.c:160-172)."""
        self.la = sid.la
        self.cn = sid.main_carrier
        if sid.cck_valid_no_hf:
            if sid.cck_id != self.cck_id:
                self.cck_id = sid.cck_id
                self.update_cck()
        else:
            self.hn = sid.hyperframe_number

    def get_ksg_key(self, addr: int) -> Key | None:
        if self.network is None:
            return None
        return self.cck

    # -- keystream -----------------------------------------------------------

    def keystream_bits(self, key: Key, t: TdmaTime, num_bits: int,
                       direction: int = 0) -> np.ndarray | None:
        if key is None or self.cn < 0 or self.la < 0 or self.cc < 0:
            return None
        ksg = tea.KSG_FUNCS.get(key.network.ksg_type if key.network else 0)
        if ksg is None:
            return None
        iv = build_iv(t, self.hn, direction)
        eck = tb5(self.cn, self.la, self.cc, key.key)
        ks_bytes = ksg(iv, eck, (num_bits + 7) // 8)
        bits = np.unpackbits(np.frombuffer(ks_bytes, np.uint8))
        return bits[:num_bits]

    def try_decrypt_mac_element(self, bits: np.ndarray, t: TdmaTime,
                                tmpdu_offset: int, addr_ssi: int = 0,
                                second_half_slot: bool = False
                                ) -> np.ndarray | None:
        """Decrypt the TM-SDU portion in place-semantics: returns the full
        bit array with bits[tmpdu_offset:] XORed with the keystream, or None
        when no key/state (decrypt_mac_element, tetra_crypto.c:221-268)."""
        key = self.get_ksg_key(addr_ssi)
        if key is None:
            return None
        skip = 216 if second_half_slot else 0
        ct_len = len(bits) - tmpdu_offset
        if ct_len <= 0:
            return None
        ks = self.keystream_bits(key, t, skip + ct_len)
        if ks is None:
            return None
        out = np.array(bits, np.uint8)
        out[tmpdu_offset:] ^= ks[skip:]
        return out

    def decrypt_voice_bits(self, t: TdmaTime, frames: np.ndarray) -> bool:
        """Hard-bit variant of decrypt_voice for the channel-decoded (2, 137)
        codec frames: the reference's sign flip of +-127 soft bits
        (decrypt_voice_timeslot, tetra_crypto.c:270-302 -- carried but never
        CALLED by the plugin) is an XOR after slicing.  Wired into
        voice/pipeline.py here, so encrypted traffic actually decodes (+).
        In-place; returns False when no CCK/keystream available."""
        key = self.cck
        ks = self.keystream_bits(key, t, 137 * 2) if key else None
        if ks is None:
            return False
        frames = frames.reshape(2, 137)
        frames[0] ^= ks[:137]
        frames[1] ^= ks[137:]
        return True

    def decrypt_voice(self, t: TdmaTime, soft_block: np.ndarray
                      ) -> bool:
        """Flip the signs of encrypted voice soft bits in the 2x137-bit
        half-slots (decrypt_voice_timeslot, tetra_crypto.c:270-302).
        soft_block layout matches the codec block of tetra_lower_mac.c:291.
        """
        key = self.cck
        ks = self.keystream_bits(key, t, 137 * 2) if key else None
        if ks is None:
            return False
        for i in range(137):
            if ks[i]:
                soft_block[i + 1] = -soft_block[i + 1]
            if ks[i + 137]:
                soft_block[i + 139] = -soft_block[i + 139]
        return True
