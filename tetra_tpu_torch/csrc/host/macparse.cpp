// Native upper-MAC receive core: the production bulk-decode path.
//
// Mirrors rx/upper_mac.py (itself a re-design of the reference's
// tetra_upper_mac.c / tetra_mac_pdu.c) bit-for-bit for the no-event-log,
// no-crypto configuration: TMV-SAP PDU loop (MAC-RESOURCE / BROADCAST /
// FRAG / END / SUPPL), SYSINFO + ACCESS-ASSIGN field extraction, fragment
// slots with N203 aging, and the MAC state flags the lower MAC reads
// (is_traffic, blk1/blk2_stolen, ssi).  The Python implementation stays the
// full-featured oracle (event log, decryption hooks); tests assert exact
// state/display parity between the two on identical streams.
//
// ABI (ctypes, see rx/native_mac.py):
//   macparse_create/destroy             -- opaque MacState*
//   macparse_state(st)                  -- raw pointer for struct mirroring
//   macparse_receive(st, bits, n, lchan, tn, fn, flags_in) -> packed flags
//     flags_in  seeds is_traffic/blk1/blk2 (Python-side writes must survive
//               calls that do not touch them);
//     return    [0:8) is_traffic | 8 blk1 | 9 blk2 | [10:13) addr_type |
//               [13:19) usage_marker | 20 aach_seen | 21 sysinfo_seen |
//               [32:56) ssi.
//   macparse_dispatch(st, bits, meta, n_items, flags_in, have_voice,
//                     have_half, base_hn, base_sn, dout, actions, times)
//     Batched lower-MAC dispatch: the whole per-channel block loop of
//     rx/lower_mac.LowerMac._dispatch_decoded (restamp-on-SYNC, timeslot
//     content, CRC counters, stolen-slot logic, PDU loop) in ONE call --
//     the per-block ctypes wrapper overhead dominated the native path's
//     remaining cost at 256 channels (ROADMAP).  `meta` is int64 (n,12):
//     [bits_off, nbits, blk_type, blk_num, crc_ok, slot_index, tn, fn,
//      mn, hn, train_seq, sn] per block; `dout` is int64[DOUT_LEN] of
//     accumulated display/cell deltas (indices mirrored in native_mac.py);
//     `actions` uint8[n] flags deferred voice work (1 full slot, 2
//     surviving half of a stolen slot); `times` int64[n,5] is each block's
//     restamped TDMA time (hn,mn,fn,tn,sn).  Returns packed flags like
//     macparse_receive.
//
// Bit-reader semantics copy mac_pdu.BitReader: MSB-first, reads past the
// end CLIP to the available bits (shorter value, not zero-padded).

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t FRAG_SLOTS = 5;
constexpr int64_t N203 = 6;
constexpr int64_t FRAG_CAP = 16384;

// logical channels (rx/upper_mac.py)
constexpr int64_t LC_AACH = 8;
constexpr int64_t LC_BSCH = 10;

// address lengths per type (mac_pdu._ADDR_LEN; type 0 unused)
constexpr int64_t ADDR_LEN[8] = {0, 24, 10, 24, 24, 34, 30, 34};

struct Frag {
  int64_t active, age, num_frags, length, encryption, nbits;
  uint8_t bits[FRAG_CAP];
};

struct Aach {
  int64_t have1, code1, val1, have2, code2, val2;
  int64_t have_dl, dl, have_ul, ul;
};

struct Sysinfo {
  int64_t main_carrier, freq_band, freq_offset, duplex_spacing,
      reverse_operation, num_of_csch, ms_txpwr_max_cell, rxlev_access_min,
      access_parameter, radio_dl_timeout, cck_valid_no_hf, cck_id,
      hyperframe_number, option_field, frame_bitmap, access_code,
      ext_service, la, subscr_class, bs_service_details, dl_freq, ul_freq;
};

struct MacState {
  int64_t is_traffic, blk1_stolen, blk2_stolen;
  int64_t ssi, usage_marker, addr_type;
  Aach aach;
  Sysinfo si;
  Frag frags[FRAG_SLOTS];
};

inline uint64_t peek(const uint8_t* b, int64_t n, int64_t pos, int64_t len) {
  int64_t end = pos + len;
  if (end > n) end = n;
  uint64_t v = 0;
  for (int64_t i = pos; i < end; i++) v = (v << 1) | (b[i] & 1);
  return v;
}

// fill bits run backwards from the end until the marker 1 bit
// (upper_mac._num_fill_bits; never examines bits[0])
inline int64_t num_fill(const uint8_t* b, int64_t n) {
  for (int64_t i = 1; i < n; i++)
    if (b[n - i]) return i;
  return 0;
}

// Table 21.89 length indicator (mac_pdu.decode_length):
// >=0 octet count, -1 START_FRAG, -2 2ND_STOLEN, -3 none/invalid
inline int64_t decode_length(uint64_t li) {
  if (li == 0 || li == 0x3B || li == 0x3C || li == 0x3D) return -3;
  if (li <= 0x3A) return (int64_t)li;
  if (li == 0x3E) return -2;
  if (li == 0x3F) return -1;
  return -3;
}

// carrier frequency (mac_pdu.dl_carrier_hz / ul_carrier_hz)
constexpr int64_t CARRIER_OFFSET_HZ[4] = {0, 6250, -6250, 12500};
constexpr int64_t DUPLEX_KHZ[8][16] = {
    {-1, 1600, 10000, 10000, 10000, 10000, 10000, -1, -1, -1, -1, -1, -1, -1, -1, -1},
    {-1, 4500, -1, 36000, 7000, -1, -1, -1, 45000, 45000, -1, -1, -1, -1, -1, -1},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {-1, -1, -1, 8000, 8000, -1, -1, -1, 18000, 18000, -1, -1, -1, -1, -1, -1},
    {-1, -1, -1, 18000, 5000, -1, 30000, 30000, -1, 39000, -1, -1, -1, -1, -1, -1},
    {-1, -1, -1, -1, 9500, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
    {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
    {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1}};

inline int64_t dl_hz(int64_t band, int64_t carrier, int64_t off) {
  return band * 100000000LL + carrier * 25000LL + CARRIER_OFFSET_HZ[off & 3];
}

inline int64_t ul_hz(int64_t band, int64_t carrier, int64_t off,
                     int64_t duplex, int64_t reverse) {
  int64_t f = dl_hz(band, carrier, off);
  int64_t sp = DUPLEX_KHZ[duplex & 7][band & 15];
  if (sp < 0) return 0;
  return reverse ? f + sp * 1000 : f - sp * 1000;
}

// channel allocation 21.5.2: bits consumed (mac_pdu.decode_chan_alloc)
int64_t chan_alloc_used(const uint8_t* b, int64_t n, int64_t start) {
  int64_t pos = start;
  auto take = [&](int64_t k) { uint64_t v = peek(b, n, pos, k); pos += k; return v; };
  take(2);                       // type
  take(4);                       // timeslot
  uint64_t ul_dl = take(2);
  take(1);                       // clch_perm
  take(1);                       // cell_chg_f
  take(12);                      // carrier_nr
  if (take(1)) pos += 4 + 2 + 3 + 1;  // extended carrier fields
  uint64_t monit = take(2);
  if (monit == 0) take(2);       // monit_patt_f18
  if (ul_dl == 0) {              // augmented channel allocation (QAM)
    pos += 2 + 3 + 3 + 3 + 3 + 3 + 4 + 5;
    uint64_t napping = take(2);
    if (napping == 1) pos += 11;
    pos += 4;
    if (take(1)) pos += 16;
    if (take(1)) pos += 16;
    pos += 1;
  }
  return pos - start;
}

void frag_reset(Frag* f) { std::memset(f, 0, sizeof(Frag)); }

void frag_append(Frag* f, const uint8_t* b, int64_t from, int64_t to) {
  if (to < from) to = from;
  int64_t len = to - from;
  int64_t room = FRAG_CAP - f->nbits;
  int64_t cp = len < room ? len : room;
  if (cp > 0) {
    std::memcpy(f->bits + f->nbits, b + from, cp);
    f->nbits += cp;
  }
  f->length += len;
}

// MAC-RESOURCE (decode_resource + _rx_resrc, no-crypto/no-events path)
int64_t rx_resrc(MacState* st, const uint8_t* b, int64_t n, int64_t tn) {
  int64_t pos = 2;
  auto take = [&](int64_t k) { uint64_t v = peek(b, n, pos, k); pos += k; return v; };
  uint64_t fill = take(1);
  take(1);                       // grant_position
  uint64_t enc_mode = take(2);
  bool is_enc = enc_mode > 0;
  take(1);                       // rand_acc_flag
  int64_t mlen = decode_length(take(6));
  int64_t atype = (int64_t)take(3);
  int64_t ssi = 0, usage = 0, tmpdu = 0;
  if (atype != 0) {
    if (atype == 1 || atype == 3 || atype == 4 || atype == 5 || atype == 7)
      ssi = (int64_t)peek(b, n, pos, 24);
    else if (atype == 6) {
      ssi = (int64_t)peek(b, n, pos, 24);
      usage = (int64_t)peek(b, n, pos + 24, 6);
    }
    pos += ADDR_LEN[atype & 7];
    if (take(1)) pos += 4;       // power control
    if (take(1)) { take(4); take(4); }  // slot granting
    uint64_t ca_pres = take(1);
    if (ca_pres && !is_enc) pos += chan_alloc_used(b, n, pos);
    tmpdu = pos;
  }
  int64_t pdu_bits = -1;
  int64_t nb = n;
  if (mlen == -2) {
    st->blk2_stolen = 1;
  } else if (mlen >= 0) {
    pdu_bits = mlen * 8;
    if (pdu_bits < nb) nb = pdu_bits;
  }
  if (fill) nb -= num_fill(b, nb);
  if (atype == 0) return -1;
  st->ssi = ssi;
  st->usage_marker = usage;
  st->addr_type = atype;
  int64_t sdu_len = nb - tmpdu;
  if (sdu_len <= 0 || is_enc) return pdu_bits;
  if (mlen == -1) {              // START_FRAG
    Frag* fs = &st->frags[tn % FRAG_SLOTS];
    frag_reset(fs);
    fs->active = 1;
    fs->num_frags = 1;
    fs->encryption = enc_mode > 0;
    frag_append(fs, b, tmpdu, nb);
  }
  // else: TM-SDU -- LLC/MLE identification feeds only the event log
  return pdu_bits;
}

int64_t rx_macfrag(MacState* st, const uint8_t* b, int64_t n, int64_t tn) {
  Frag* fs = &st->frags[tn % FRAG_SLOTS];
  if (!fs->active) return -1;
  uint64_t fill = peek(b, n, 3, 1);
  int64_t nb = n;
  if (fill) nb -= num_fill(b, nb);
  frag_append(fs, b, 4, nb);
  fs->num_frags += 1;
  fs->age = 0;
  return -1;
}

int64_t rx_macend(MacState* st, const uint8_t* b, int64_t n, int64_t tn) {
  Frag* fs = &st->frags[tn % FRAG_SLOTS];
  int64_t pos = 2;
  auto take = [&](int64_t k) { uint64_t v = peek(b, n, pos, k); pos += k; return v; };
  take(1);                       // MAC-END marker
  uint64_t fill = take(1);
  take(1);                       // position of grant
  int64_t li = (int64_t)take(6);
  if (fs->active) {
    if (take(1)) take(8);        // slot granting
    uint64_t ca = take(1);
    int64_t nb = li * 8;
    if (nb > n) nb = n;
    if (fill) nb -= num_fill(b, nb);
    if (ca) pos += chan_alloc_used(b, n, pos);
    frag_append(fs, b, pos, nb);
    // reassembled TM-SDU -> LLC/MLE identification: event-log only
  }
  frag_reset(fs);
  return li * 8;
}

void rx_aach(MacState* st, const uint8_t* b, int64_t n, int64_t fn) {
  uint64_t v = peek(b, n, 0, 14);
  int64_t hdr = (int64_t)(v >> 12);
  int64_t f1 = (int64_t)((v >> 6) & 0x3F);
  int64_t f2 = (int64_t)(v & 0x3F);
  Aach* a = &st->aach;
  a->have1 = a->have2 = a->have_dl = a->have_ul = 0;
  auto set1 = [&](int64_t f) { a->have1 = 1; a->code1 = (f >> 4) & 3; a->val1 = f & 0xF; };
  auto set2 = [&](int64_t f) { a->have2 = 1; a->code2 = (f >> 4) & 3; a->val2 = f & 0xF; };
  if (fn != 18) {
    if (hdr == 0) { set1(f1); set2(f2); }
    else if (hdr == 1 || hdr == 2) { a->have_dl = 1; a->dl = f1; set2(f2); }
    else { a->have_dl = 1; a->dl = f1; a->have_ul = 1; a->ul = f2; }
  } else {
    if (hdr <= 2) { set1(f1); set2(f2); }
    else set2(f2);
  }
  st->is_traffic = (a->have_dl && a->dl > 3) ? a->dl : 0;
  st->blk1_stolen = 0;
  st->blk2_stolen = 0;
}

int64_t rx_bcast(MacState* st, const uint8_t* b, int64_t n) {
  int64_t pos = 4;               // 2 broadcast hdr + 2 sysinfo subtype
  auto take = [&](int64_t k) { uint64_t v = peek(b, n, pos, k); pos += k; return (int64_t)v; };
  Sysinfo* s = &st->si;
  s->main_carrier = take(12);
  s->freq_band = take(4);
  s->freq_offset = take(2);
  s->duplex_spacing = take(3);
  s->reverse_operation = take(1);
  s->num_of_csch = take(2);
  s->ms_txpwr_max_cell = take(3);
  s->rxlev_access_min = take(4);
  s->access_parameter = take(4);
  s->radio_dl_timeout = take(4);
  s->cck_valid_no_hf = take(1);
  s->cck_id = 0;
  s->hyperframe_number = 0;
  if (s->cck_valid_no_hf) s->cck_id = take(16);
  else s->hyperframe_number = take(16);
  s->option_field = take(2);
  s->frame_bitmap = s->access_code = s->ext_service = 0;
  if (s->option_field <= 1) s->frame_bitmap = take(20);
  else if (s->option_field == 2) s->access_code = take(20);
  else s->ext_service = take(20);
  // D-MLE-SYSINFO at fixed offset 124-42 (tetra_mac_pdu.c:80)
  int64_t mp = 124 - 42;
  s->la = (int64_t)peek(b, n, mp, 14);
  s->subscr_class = (int64_t)peek(b, n, mp + 14, 16);
  s->bs_service_details = (int64_t)peek(b, n, mp + 30, 12);
  s->dl_freq = dl_hz(s->freq_band, s->main_carrier, s->freq_offset);
  s->ul_freq = ul_hz(s->freq_band, s->main_carrier, s->freq_offset,
                     s->duplex_spacing, s->reverse_operation);
  return -1;
}

// shared receive body (rx_tmv_unitdata_ind + the PDU while-loop); `seen`
// accumulates the aach/sysinfo bits (1<<20 / 1<<21)
void receive_core(MacState* st, const uint8_t* bits, int64_t n, int64_t lchan,
                  int64_t tn, int64_t fn, uint64_t* seen) {
  if (fn == 18) {                // age fragment slots (REASSEMBLE_FRAGMENTS)
    for (auto& f : st->frags)
      if (f.active && ++f.age > N203) frag_reset(&f);
  }
  if (lchan == LC_AACH) {
    rx_aach(st, bits, n, fn);
    *seen |= 1ull << 20;
  } else if (lchan != LC_BSCH) {
    int64_t offset = 0;
    while (offset < n - 16) {
      const uint8_t* b = bits + offset;
      int64_t bn = n - offset;
      uint64_t pt = peek(b, bn, 0, 2);
      int64_t r;
      if (pt == 2) {             // BROADCAST
        r = rx_bcast(st, b, bn);
        *seen |= 1ull << 21;
      } else if (pt == 0) {      // MAC-RESOURCE
        r = rx_resrc(st, b, bn, tn);
      } else if (pt == 1) {      // FRAG/END
        r = (b[2] == 0) ? rx_macfrag(st, b, bn, tn)
                        : rx_macend(st, b, bn, tn);
      } else {                   // MAC-SUPPL: event-log only
        r = -1;
      }
      if (r < 0) break;
      offset += r;
    }
  }
}

uint64_t pack_flags(const MacState* st, uint64_t seen) {
  return (uint64_t)(st->is_traffic & 0xFF) |
         ((uint64_t)(st->blk1_stolen & 1) << 8) |
         ((uint64_t)(st->blk2_stolen & 1) << 9) |
         ((uint64_t)(st->addr_type & 7) << 10) |
         ((uint64_t)(st->usage_marker & 0x3F) << 13) | seen |
         ((uint64_t)(st->ssi & 0xFFFFFF) << 32);
}

// TDMA time with rx/tdma.py's normalization quirks (tn normalizes only
// when > 4 and the modulo keeps 0; mn wraps modulo 60 keeping 0; hn/sn
// never carried by add_tn)
struct TTime { int64_t hn, mn, fn, tn, sn; };

void add_tn(TTime* t, int64_t n) {
  t->tn += n;
  if (t->tn > 4) { t->fn += t->tn / 4; t->tn %= 4; }
  if (t->fn > 18) { t->mn += t->fn / 18; t->fn %= 18; }
  if (t->mn > 60) t->mn %= 60;
}

// Floor division/modulo (Python semantics): C++ '/'/'%' truncate toward
// zero, which diverges from TdmaTime.add_tn_bulk on denormalized inputs
// (e.g. an OTA-corrupted mn=0 gave 0 here but 60 in Python).  Explicit
// floor-mod keeps the twins equal on ALL inputs, not just in-range ones.
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
inline int64_t floormod(int64_t a, int64_t b) { return a - floordiv(a, b) * b; }

// Advance n timeslots exactly as n repeated add_tn(1) steps (the
// reference's serial per-slot stepping).  add_tn's quirky normalization is
// not additive across batch sizes (tn can even land on 0 for n > 1), so
// batch-lag corrections and in-batch restamps -- which exist only because
// we batch -- must use this batching-invariant form (TdmaTime.add_tn_bulk
// is the Python twin).
void add_tn_serial(TTime* t, int64_t n) {
  int64_t tt = t->tn - 1 + n;
  t->tn = floormod(tt, 4) + 1;
  int64_t ff = t->fn - 1 + floordiv(tt, 4);
  t->fn = floormod(ff, 18) + 1;
  t->mn = floormod(t->mn - 1 + floordiv(ff, 18), 60) + 1;
}

// Normalize OTA SYNC PDU frame/multiframe fields into their valid ranges
// (fn: 5 bits OTA but 1..18 valid; mn: 6 bits OTA but 1..60 valid).  A
// noise-corrupted CRC-passing SYNC could otherwise store a denormalized
// value that the add_tn twins then disagree on (ADVICE r2).
inline int64_t norm_field(int64_t v, int64_t m) {
  return floormod(v - 1, m) + 1;
}

// dout indices (mirrored as D_* in rx/native_mac.py)
enum {
  D_CRC_OK = 0, D_CRC_FAIL, D_LAST_CRC_FAIL, D_SI_SEEN, D_HF_SEEN, D_HF_VAL,
  D_A_HAVE1, D_A_CODE1, D_A_VAL1, D_A_HAVE2, D_A_CODE2, D_A_VAL2,
  D_A_HAVE_DL, D_A_DL, D_A_HAVE_UL, D_A_UL,
  D_CONTENT0, D_CONTENT1, D_CONTENT2, D_CONTENT3,
  D_LAST_MN, D_LAST_FN,
  D_SB1_SEEN, D_MCC, D_MNC, D_CC,
  D_SB1_OK, D_CELL_MCC, D_CELL_MNC, D_CELL_CC,
  D_CELL_TN, D_CELL_FN, D_CELL_MN, D_CELL_SIDX,
  DOUT_LEN
};

// block types (params.TPSAP_T_*) and train-seq ids (params.TRAIN_SEQ_*)
constexpr int64_t T_SB1 = 0, T_SB2 = 1, T_NDB = 2, T_BBK = 3, T_SCH_F = 5;
constexpr int64_t TS_NORM_2 = 1, TS_SYNC = 3;

}  // namespace

extern "C" {

MacState* macparse_create() {
  MacState* st = new MacState();
  std::memset(st, 0, sizeof(MacState));
  return st;
}

void macparse_destroy(MacState* st) { delete st; }

void* macparse_state(MacState* st) { return st; }

int64_t macparse_state_size() { return (int64_t)sizeof(MacState); }

uint64_t macparse_receive(MacState* st, const uint8_t* bits, int64_t n,
                          int64_t lchan, int64_t tn, int64_t fn,
                          uint64_t flags_in) {
  st->is_traffic = (int64_t)(flags_in & 0xFF);
  st->blk1_stolen = (int64_t)((flags_in >> 8) & 1);
  st->blk2_stolen = (int64_t)((flags_in >> 9) & 1);
  uint64_t seen = 0;
  receive_core(st, bits, n, lchan, tn, fn, &seen);
  return pack_flags(st, seen);
}

uint64_t macparse_dispatch(MacState* st, const uint8_t* bits,
                           const int64_t* meta, int64_t n_items,
                           uint64_t flags_in, int64_t have_voice,
                           int64_t have_half, int64_t base_hn, int64_t base_sn,
                           int64_t* dout, uint8_t* actions, int64_t* times) {
  st->is_traffic = (int64_t)(flags_in & 0xFF);
  st->blk1_stolen = (int64_t)((flags_in >> 8) & 1);
  st->blk2_stolen = (int64_t)((flags_in >> 9) & 1);
  for (int64_t i = 0; i < DOUT_LEN; i++) dout[i] = 0;
  dout[D_LAST_CRC_FAIL] = -1;
  for (int64_t i = 0; i < 4; i++) dout[D_CONTENT0 + i] = -1;
  dout[D_LAST_MN] = dout[D_LAST_FN] = -1;
  bool resync = false;
  TTime base{};
  int64_t base_idx = 0;
  for (int64_t i = 0; i < n_items; i++) {
    const int64_t* m = meta + i * 12;
    const uint8_t* b = bits + m[0];
    int64_t nb = m[1], bt = m[2], bnum = m[3], ok = m[4], sidx = m[5];
    TTime t{m[9], m[8], m[7], m[6], m[11]};
    if (resync && sidx > base_idx) {  // restamp bursts stamped pre-resync
      t = base;
      add_tn_serial(&t, sidx - base_idx);
    }
    int64_t* tout = times + i * 5;
    tout[0] = t.hn; tout[1] = t.mn; tout[2] = t.fn; tout[3] = t.tn;
    tout[4] = t.sn;
    actions[i] = 0;
    dout[D_LAST_MN] = t.mn;
    dout[D_LAST_FN] = t.fn;
    int64_t tc = (m[10] == TS_SYNC)   ? 3
                 : (m[10] == TS_NORM_2) ? 2
                 : (st->is_traffic ? 4 : 1);
    dout[D_CONTENT0 + (((t.tn - 1) % 4 + 4) % 4)] = tc;
    bool is_voice_slot = (bt == T_SCH_F && st->is_traffic);
    if (ok) dout[D_CRC_OK]++;
    else if (!is_voice_slot) dout[D_CRC_FAIL]++;
    int64_t lchan = 0;  // LC_UNKNOWN
    if (bt == T_SB1) {  // SYNC PDU parsed inline (tetra_lower_mac.c:246-276)
      dout[D_SB1_SEEN] = 1;
      dout[D_MCC] = (int64_t)peek(b, nb, 31, 10);
      dout[D_MNC] = (int64_t)peek(b, nb, 41, 14);
      dout[D_CC] = (int64_t)peek(b, nb, 4, 6);
      if (ok) {
        dout[D_SB1_OK] = 1;
        dout[D_CELL_MCC] = dout[D_MCC];
        dout[D_CELL_MNC] = dout[D_MNC];
        dout[D_CELL_CC] = dout[D_CC];
        dout[D_CELL_TN] = (int64_t)peek(b, nb, 10, 2) + 1;
        dout[D_CELL_FN] = norm_field((int64_t)peek(b, nb, 12, 5), 18);
        dout[D_CELL_MN] = norm_field((int64_t)peek(b, nb, 17, 6), 60);
        dout[D_CELL_SIDX] = sidx;
        base = TTime{base_hn, dout[D_CELL_MN], dout[D_CELL_FN],
                     dout[D_CELL_TN], base_sn};
        base_idx = sidx;
        resync = true;
        dout[D_LAST_CRC_FAIL] = 0;
      } else {
        dout[D_LAST_CRC_FAIL] = 1;
      }
      lchan = LC_BSCH;
    } else if (bt == T_BBK) {
      lchan = LC_AACH;
    } else if (bt == T_SB2) {
      lchan = (t.fn == 18 && t.tn == 4 - ((t.mn + 3) % 4)) ? 11 : 0;  // BNCH
      dout[D_LAST_CRC_FAIL] = ok ? 0 : 1;
    } else if (bt == T_SCH_F) {
      lchan = 1;  // LC_SCH_F
      if (ok) dout[D_LAST_CRC_FAIL] = 0;
      if (st->is_traffic && have_voice) actions[i] = 1;
    } else if (bt == T_NDB) {
      // clause 19.4.4 slot stealing (rx/lower_mac.py NDB branch)
      if (st->is_traffic && bnum == 1) st->blk1_stolen = 1;
      if (st->is_traffic && bnum == 2 && st->blk1_stolen &&
          !st->blk2_stolen) {
        if (have_half) actions[i] = 2;  // surviving half carries speech
        continue;
      }
      dout[D_LAST_CRC_FAIL] = ok ? 0 : 1;
    } else {
      dout[D_LAST_CRC_FAIL] = ok ? 0 : 1;
    }
    if (!ok) continue;  // upper_mac.receive gates on crc_ok
    uint64_t seen = 0;
    receive_core(st, b, nb, lchan, t.tn, t.fn, &seen);
    if (seen & (1ull << 20)) {  // accumulate AACH display deltas
      const Aach* a = &st->aach;
      if (a->have1) {
        dout[D_A_HAVE1] = 1; dout[D_A_CODE1] = a->code1;
        dout[D_A_VAL1] = a->val1;
      }
      if (a->have2) {
        dout[D_A_HAVE2] = 1; dout[D_A_CODE2] = a->code2;
        dout[D_A_VAL2] = a->val2;
      }
      if (a->have_dl) { dout[D_A_HAVE_DL] = 1; dout[D_A_DL] = a->dl; }
      if (a->have_ul) { dout[D_A_HAVE_UL] = 1; dout[D_A_UL] = a->ul; }
    }
    if (seen & (1ull << 21)) {
      dout[D_SI_SEEN] = 1;
      if (!st->si.cck_valid_no_hf) {
        dout[D_HF_SEEN] = 1;
        dout[D_HF_VAL] = st->si.hyperframe_number;
      }
    }
  }
  return pack_flags(st, 0);
}

}  // extern "C"
