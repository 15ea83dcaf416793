// Native multi-channel steady-state receiver engine ("fleet" path).
//
// Closes the host-stack gap (VERDICT round 1, item 1): the per-channel
// Python loops of rx/burst_sync.BurstSync.feed and the per-channel display
// delta application of rx/lower_mac._dispatch_native dominated the full
// IQ->PDU pipeline at 256+ channels (~1000x below the demod-only headline).
// This engine owns per-channel state for the WHOLE bit pipeline around the
// batched device FEC call:
//
//   fleet_feed:      (C, T) dibits+valid -> per-channel bit append, the
//                    exact BurstSync state machine (UNLOCKED/KNOW_FSTART/
//                    LOCKED; re-design of phy/tetra_burst_sync.c:54-155),
//                    burst field splitting (tetra_burst.c:343-393 layouts)
//                    -- emitting ONE zero-padded (N, 432) type-5 matrix +
//                    meta rows, ready for rx.fec.decode_rows_mixed.
//   fleet_dispatch:  decoded (N, 268) type-1 rows + crc flags -> the full
//                    lower/upper MAC dispatch per channel (macparse.cpp
//                    receive core + the display/cell/PHY-time bookkeeping
//                    of rx/lower_mac.LowerMac), all state held natively.
//
// Python's per-cycle work becomes two ctypes calls + one device call,
// independent of channel count.  Semantics are kept EXACTLY equal to the
// Python pipeline (rx/burst_sync.py + rx/lower_mac.py in the no-event,
// no-crypto production configuration); tests/test_fleet.py fuzzes parity.
//
// Built together with macparse.cpp (included below) into libtetra_fleet.so.

#include <functional>
#include <thread>
#include <vector>

#include "macparse.cpp"

namespace {

// burst-sync states (rx/burst_sync.py)
constexpr int64_t RX_UNLOCKED = 0;
constexpr int64_t RX_KNOW_FSTART = 1;
constexpr int64_t RX_LOCKED = 2;

constexpr int64_t BITS_PER_TS = 510;
constexpr int64_t SYNC_TRAIN_OFFSET = 214;
constexpr int64_t NORM_TRAIN_OFFSET = 244;
constexpr int64_t SYNC_TO_NEXT = 296;
constexpr int64_t UNLOCK_KEEP = 4096;   // BurstSync._unlock keep window

// train_seq ids (params.py)
constexpr int64_t TS_NORM_1_ID = 0;
constexpr int64_t TS_NORM_2_ID = 1;
constexpr int64_t TS_SYNC_ID = 3;

// burst field layout (params.py:99-112 <- tetra_burst.c:33-49)
constexpr int64_t SB_BLK1_OFF = 94, SB_BLK1_BITS_N = 120;
constexpr int64_t SB_BBK_OFF = 252, SB_BBK_BITS_N = 30;
constexpr int64_t SB_BLK2_OFF = 282, SB_BLK2_BITS_N = 216;
constexpr int64_t NDB_BLK1_OFF = 14, NDB_BBK1_OFF = 230, NDB_BBK1_BITS_N = 14;
constexpr int64_t NDB_BBK2_OFF = 266, NDB_BBK2_BITS_N = 16;
constexpr int64_t NDB_BLK2_OFF = 282, NDB_BLK_BITS_N = 216;

constexpr int64_t FLEET_BUFCAP = 1 << 16;   // bits (BurstSync.bufsize)
constexpr int64_t T5P_BYTES = 54;           // bit-packed type-5 row (432/8)
constexpr int64_t T1P_BYTES = 34;           // bit-packed type-1 row (272/8)
constexpr int64_t META_COLS = 12;  // chan, blk_type, blk_num, slot_index,
                                   // tn, fn, mn, hn, sn, train_seq, t345, rsv

// display state mirror (rx/display.py DisplayState; FleetDisp in fleet.py)
struct Disp {
  int64_t curr_hyperframe, curr_multiframe, curr_frame;
  int64_t timeslot_content[4];
  int64_t dl_usage, ul_usage;
  int64_t access1_code, access2_code, access1, access2;  // code: 0 = unset
  int64_t dl_freq, ul_freq, mcc, mnc, cc;
  int64_t last_crc_fail;
  int64_t flags[11];  // BS_SERVICE_FLAGS order (rx/mac_pdu.py, None slot
                      // omitted): advanced_link, air_encryption, sndcp_data,
                      // circuit_data, voice_service, normal_mode,
                      // migration_supported, never_minimum_mode,
                      // priority_cell, dereg_mandatory, reg_mandatory
};

struct FleetChan {
  // burst sync (rx/burst_sync.BurstSync fields)
  int64_t state, start_bitnum, next_frame, scan_from, lock_losses;
  int64_t buf_len;
  // PHY (rx/tdma.PhyState)
  TTime time;
  int64_t slot_count;
  // cell (rx/lower_mac.CellData)
  int64_t cell_mcc, cell_mnc, cell_cc, scramb_init;
  TTime cell_time;
  // counters (rx/lower_mac.LowerMac)
  int64_t crc_oks, crc_fails;
  Disp disp;
  MacState mac;
  // cached scrambling keystream for the local BBK decode (regenerated when
  // the channel's scrambling code changes)
  int64_t ks_scramb;
  uint8_t ks30[30];
  uint8_t buf[FLEET_BUFCAP];
};

struct Fleet {
  int64_t C;
  int64_t scramb_default;
  // training sequences (passed from params at create: single source of truth)
  int64_t ylen, nlen, plen;
  uint8_t y[64], n[64], p[64];
  FleetChan* ch;        // C channel states
  int64_t* scramb;      // (C,) current scrambling inits (numpy view)
  // local RM(30,14) decode (fleet_set_rm): syndrome-table bounded-distance
  // decoding, bit-exact to rx/fec.rm3014_decode's ML-with-dist<=3
  // acceptance (d_min = 8 makes the <=3-error region uniquely decodable,
  // so BDD and ML agree exactly there; both reject at >= 4).  BBK rows
  // then never cross the device link -- they were ~1/3 of every FEC batch
  // and their 35-byte result rows ~1/3 of the dominant output fetch.
  bool rm_ready = false;
  uint64_t scramb_tapmask = 0;
  uint16_t rm_rows[14];        // parity row i as 16-bit mask (bit j)
  uint32_t rm_syn[1 << 16];    // syndrome -> 30-bit error mask; ~0u invalid
  // worker threads for the per-channel loops (channels are fully
  // independent: chan_feed* take const Fleet* and own FleetChan;
  // chan_dispatch writes only its channel's state + disjoint per-row
  // outputs).  1 = sequential (default); fleet_set_threads() enables.
  int64_t nthreads = 1;
};

// TETRA scrambling sequence p(k) (8.2.5; tx/fec_enc.scramb_keystream):
// 32-bit Fibonacci LFSR, output = parity(lfsr & tapmask), shifted in at top
inline void gen_keystream(uint64_t init, uint64_t tapmask, uint8_t* out,
                          int64_t n) {
  uint32_t lfsr = (uint32_t)init;
  uint32_t mask = (uint32_t)tapmask;
  for (int64_t i = 0; i < n; i++) {
    uint32_t b = (uint32_t)__builtin_parity(lfsr & mask);
    lfsr = (lfsr >> 1) | (b << 31);
    out[i] = (uint8_t)b;
  }
}

// syndrome of a 30-bit word: XOR of per-position signatures (info position
// i contributes parity row i; parity position j contributes bit j)
inline uint16_t rm_syndrome(const Fleet* f, const uint8_t* d30) {
  uint16_t s = 0;
  for (int i = 0; i < 14; i++)
    if (d30[i]) s ^= f->rm_rows[i];
  for (int j = 0; j < 16; j++)
    if (d30[14 + j]) s ^= (uint16_t)(1u << j);
  return s;
}

// descramble + decode one BBK block; returns info14 (MSB-first value,
// bit 13-k = decoded type-1 bit k) | ok << 14
inline int64_t rm_decode_local(const Fleet* f, const uint8_t* bits30,
                               const uint8_t* ks30) {
  uint8_t d[30];
  for (int k = 0; k < 30; k++) d[k] = (uint8_t)((bits30[k] ^ ks30[k]) & 1);
  uint32_t e = f->rm_syn[rm_syndrome(f, d)];
  if (e == ~0u) return 0;                 // >= 4 errors: reject (ok = 0)
  int64_t info = 0;
  for (int k = 0; k < 14; k++) {
    int64_t b = d[k] ^ ((e >> k) & 1);
    info |= b << (13 - k);
  }
  return info | (1ll << 14);
}

inline void chan_ensure_ks(const Fleet* f, FleetChan* c, int64_t scramb) {
  if (c->ks_scramb == scramb) return;
  gen_keystream((uint64_t)scramb, f->scramb_tapmask, c->ks30, 30);
  c->ks_scramb = scramb;
}

inline bool match_at(const uint8_t* buf, int64_t len, int64_t off,
                     const uint8_t* seq, int64_t slen) {
  if (off < 0 || off + slen > len) return false;
  return std::memcmp(buf + off, seq, (size_t)slen) == 0;
}

// earliest full match of seq in buf[from..len): returns offset or -1
inline int64_t find_seq(const uint8_t* buf, int64_t len, int64_t from,
                        const uint8_t* seq, int64_t slen) {
  if (from < 0) from = 0;
  for (int64_t o = from; o + slen <= len; o++) {
    if (buf[o] == seq[0] && std::memcmp(buf + o, seq, (size_t)slen) == 0)
      return o;
  }
  return -1;
}

// find_train_seq(bits, which) semantics (rx/burst_sync.py:38-56): earliest
// offset wins; ties broken by `which` order.  which = bitmask of seq ids.
inline int64_t find_train(const Fleet* f, const uint8_t* buf, int64_t len,
                          bool with_norm, int64_t* seq_out) {
  // order in _SEARCH_SEQS_LOCKED: SYNC, NORM_1, NORM_2
  int64_t best = -1, best_seq = -1;
  int64_t oy = find_seq(buf, len, 0, f->y, f->ylen);
  if (oy >= 0) { best = oy; best_seq = TS_SYNC_ID; }
  if (with_norm) {
    int64_t on = find_seq(buf, len, 0, f->n, f->nlen);
    if (on >= 0 && (best < 0 || on < best)) { best = on; best_seq = TS_NORM_1_ID; }
    int64_t op = find_seq(buf, len, 0, f->p, f->plen);
    if (op >= 0 && (best < 0 || op < best)) { best = op; best_seq = TS_NORM_2_ID; }
  }
  *seq_out = best_seq;
  return best;
}

inline void chan_unlock(FleetChan* c) {
  // BurstSync._unlock: drop stale bits beyond the reference's 4096-bit
  // window so re-acquisition does not latch onto minutes-old bursts
  c->state = RX_UNLOCKED;
  c->lock_losses++;
  if (c->buf_len > UNLOCK_KEEP) {
    int64_t drop = c->buf_len - UNLOCK_KEEP;
    std::memmove(c->buf, c->buf + drop, (size_t)(c->buf_len - drop));
    c->buf_len -= drop;
    c->start_bitnum += drop;
  }
  c->scan_from = c->start_bitnum;
}

// emit one block row: BIT-PACKED type-5 bits (MSB-first per byte; the
// whole row crosses the host->device link, so packing cuts it 8x) + meta.
// BBK rows are additionally decoded LOCALLY (syndrome RM(30,14), see
// Fleet.rm_syn) with the channel's current keystream: meta[11] carries
// info14 | ok<<14 | 1<<15 and the Python side keeps those rows off the
// device batch entirely (adoption redo re-runs them via
// fleet_rm_redecode).  The packed type-5 bits stay in the row regardless.
inline int64_t emit_block(const Fleet* f, FleetChan* c, int64_t chan,
                          int64_t blk_type, int64_t blk_num,
                          int64_t train_seq,
                          const uint8_t* bits, int64_t nbits,
                          uint8_t* t5, int64_t* meta, int64_t row,
                          int64_t cap) {
  if (row >= cap) return row + 1;  // overflow signalled to caller
  uint8_t* dst = t5 + row * T5P_BYTES;
  std::memset(dst, 0, (size_t)T5P_BYTES);
  for (int64_t b = 0; b < nbits; b++)
    dst[b >> 3] |= (uint8_t)((bits[b] & 1) << (7 - (b & 7)));
  int64_t* m = meta + row * META_COLS;
  m[0] = chan; m[1] = blk_type; m[2] = blk_num; m[3] = c->slot_count;
  m[4] = c->time.tn; m[5] = c->time.fn; m[6] = c->time.mn; m[7] = c->time.hn;
  m[8] = c->time.sn; m[9] = train_seq; m[10] = nbits; m[11] = 0;
  if (blk_type == T_BBK && f->rm_ready) {
    chan_ensure_ks(f, c, f->scramb[chan]);
    m[11] = rm_decode_local(f, bits, c->ks30) | (1ll << 15);
  }
  return row + 1;
}

// split one 510-bit burst into typed blocks (Burst.blocks(),
// rx/burst_sync.py:67-94 <- tetra_burst_rx_cb, tetra_burst.c:343-393)
inline int64_t emit_burst(const Fleet* f, FleetChan* c, int64_t chan,
                          int64_t seq_id,
                          const uint8_t* b, uint8_t* t5, int64_t* meta,
                          int64_t row, int64_t cap) {
  if (seq_id == TS_SYNC_ID) {
    row = emit_block(f, c, chan, T_SB1, 1, seq_id, b + SB_BLK1_OFF,
                     SB_BLK1_BITS_N, t5, meta, row, cap);
    row = emit_block(f, c, chan, T_BBK, 0, seq_id, b + SB_BBK_OFF,
                     SB_BBK_BITS_N, t5, meta, row, cap);
    row = emit_block(f, c, chan, T_SB2, 2, seq_id, b + SB_BLK2_OFF,
                     SB_BLK2_BITS_N, t5, meta, row, cap);
    return row;
  }
  uint8_t bbk[SB_BBK_BITS_N];
  std::memcpy(bbk, b + NDB_BBK1_OFF, NDB_BBK1_BITS_N);
  std::memcpy(bbk + NDB_BBK1_BITS_N, b + NDB_BBK2_OFF, NDB_BBK2_BITS_N);
  if (seq_id == TS_NORM_2_ID) {
    row = emit_block(f, c, chan, T_BBK, 0, seq_id, bbk, SB_BBK_BITS_N, t5, meta,
                     row, cap);
    row = emit_block(f, c, chan, T_NDB, 1, seq_id, b + NDB_BLK1_OFF,
                     NDB_BLK_BITS_N, t5, meta, row, cap);
    row = emit_block(f, c, chan, T_NDB, 2, seq_id, b + NDB_BLK2_OFF,
                     NDB_BLK_BITS_N, t5, meta, row, cap);
    return row;
  }
  // NORM_1: BBK + SCH/F (two 216-bit halves concatenated)
  uint8_t schf[2 * NDB_BLK_BITS_N];
  std::memcpy(schf, b + NDB_BLK1_OFF, NDB_BLK_BITS_N);
  std::memcpy(schf + NDB_BLK_BITS_N, b + NDB_BLK2_OFF, NDB_BLK_BITS_N);
  row = emit_block(f, c, chan, T_BBK, 0, seq_id, bbk, SB_BBK_BITS_N, t5, meta,
                   row, cap);
  row = emit_block(f, c, chan, T_SCH_F, 0, seq_id, schf, 2 * NDB_BLK_BITS_N, t5,
                   meta, row, cap);
  return row;
}

// drop oldest ring bits so nbits more fit (make_bitbuf_space semantics)
inline void chan_make_space(FleetChan* c, int64_t nbits) {
  int64_t total = c->buf_len + nbits;
  if (total > FLEET_BUFCAP) {
    int64_t drop = total - FLEET_BUFCAP;
    if (drop > c->buf_len) drop = c->buf_len;
    std::memmove(c->buf, c->buf + drop, (size_t)(c->buf_len - drop));
    c->buf_len -= drop;
    c->start_bitnum += drop;
  }
}

// run the burst-sync state machine over whatever is buffered: exact
// BurstSync.feed consume loop (rx/burst_sync.py:144-273)
int64_t chan_consume(const Fleet* f, FleetChan* c, int64_t chan,
                     uint8_t* t5, int64_t* meta, int64_t row, int64_t cap) {
  bool progress = true;
  while (progress) {
    progress = false;
    if (c->state == RX_UNLOCKED) {
      if (c->buf_len < BITS_PER_TS * 2) break;
      int64_t start = c->scan_from - c->start_bitnum - (f->ylen - 1);
      if (start < 0) start = 0;
      int64_t offs = find_seq(c->buf, c->buf_len, start, f->y, f->ylen);
      if (offs < 0) {
        c->scan_from = c->start_bitnum + c->buf_len;
        break;
      }
      c->state = RX_KNOW_FSTART;
      c->next_frame = c->start_bitnum + offs + SYNC_TO_NEXT;
      // (+) decode the ANCHOR burst itself (rx/burst_sync.py UNLOCKED
      // branch): its 510-bit slot is already buffered when offs >= 214
      int64_t a0 = offs - SYNC_TRAIN_OFFSET;
      if (a0 >= 0 && a0 + BITS_PER_TS <= c->buf_len) {
        add_tn(&c->time, 1);
        c->slot_count++;
        row = emit_burst(f, c, chan, TS_SYNC_ID, c->buf + a0, t5, meta, row,
                         cap);
      }
      progress = true;
    } else if (c->state == RX_KNOW_FSTART) {
      if (c->start_bitnum + c->buf_len < c->next_frame) break;
      int64_t offset = c->next_frame - c->start_bitnum;
      std::memmove(c->buf, c->buf + offset, (size_t)(c->buf_len - offset));
      c->buf_len -= offset;
      c->start_bitnum += offset;
      c->next_frame += BITS_PER_TS;
      c->state = RX_LOCKED;
      progress = true;
    } else {  // RX_LOCKED
      if (c->buf_len < BITS_PER_TS) break;
      add_tn(&c->time, 1);
      c->slot_count++;
      // steady-state fast path: expected offsets first (y@214, n/p@244)
      int64_t seq_id = -1, offs = -1;
      if (match_at(c->buf, c->buf_len, SYNC_TRAIN_OFFSET, f->y, f->ylen)) {
        seq_id = TS_SYNC_ID; offs = SYNC_TRAIN_OFFSET;
      } else if (match_at(c->buf, c->buf_len, NORM_TRAIN_OFFSET, f->n,
                          f->nlen)) {
        seq_id = TS_NORM_1_ID; offs = NORM_TRAIN_OFFSET;
      } else if (match_at(c->buf, c->buf_len, NORM_TRAIN_OFFSET, f->p,
                          f->plen)) {
        seq_id = TS_NORM_2_ID; offs = NORM_TRAIN_OFFSET;
      }
      if (seq_id < 0) {
        int64_t scan = BITS_PER_TS + 64;
        if (scan > c->buf_len) scan = c->buf_len;
        offs = find_train(f, c->buf, scan, true, &seq_id);
        if (offs < 0)
          offs = find_train(f, c->buf, c->buf_len, true, &seq_id);
      }
      if (offs < 0) {
        chan_unlock(c);
      } else if (seq_id == TS_SYNC_ID) {
        if (offs == SYNC_TRAIN_OFFSET) {
          row = emit_burst(f, c, chan, seq_id, c->buf, t5, meta, row, cap);
        } else {
          // wrong-offset SYNC: re-align directly to the fresh y instead of
          // unlocking (documented + deviation, rx/burst_sync.py:245-260)
          c->lock_losses++;
          c->state = RX_KNOW_FSTART;
          c->next_frame = c->start_bitnum + offs + SYNC_TO_NEXT;
          progress = true;
          continue;
        }
      } else if (offs == NORM_TRAIN_OFFSET) {
        row = emit_burst(f, c, chan, seq_id, c->buf, t5, meta, row, cap);
      }  // wrong-offset NORM: ignored, stay locked
      std::memmove(c->buf, c->buf + BITS_PER_TS,
                   (size_t)(c->buf_len - BITS_PER_TS));
      c->buf_len -= BITS_PER_TS;
      c->start_bitnum += BITS_PER_TS;
      c->next_frame += BITS_PER_TS;
      progress = true;
    }
  }
  return row;
}

// one channel's feed: exact BurstSync.feed (rx/burst_sync.py:144-273).
// Input is the demod's PACKED BYTE output: bit 7 = valid, bits 1:0 = dibit
// (one byte per symbol slot).
int64_t chan_feed(const Fleet* f, FleetChan* c, int64_t chan,
                  const uint8_t* packed, int64_t T,
                  uint8_t* t5, int64_t* meta, int64_t row, int64_t cap) {
  // dibits -> bits, MSB first (rx/demod.dibits_to_bits), appended under the
  // bufsize cap (feed drops oldest bits first, like make_bitbuf_space)
  int64_t nbits = 0;
  for (int64_t t = 0; t < T; t++) nbits += (packed[t] & 0x80) ? 2 : 0;
  if (nbits == 0) return row;
  chan_make_space(c, nbits);
  uint8_t* w = c->buf + c->buf_len;
  for (int64_t t = 0; t < T; t++) {
    uint8_t d = packed[t];
    if (!(d & 0x80)) continue;
    *w++ = (d >> 1) & 1;
    *w++ = d & 1;
  }
  c->buf_len += nbits;
  return chan_consume(f, c, chan, t5, meta, row, cap);
}

// one channel's feed from the superblock's TIME-MAJOR 2-bit stream
// (rx/receiver.pack_cycle_tc): `sym` points at the channel's column in the
// cycle's symbol rows (n_chunks*2 int32 words, 16 two-bit dibits each,
// lowest bits first, stride strideC); `cnt` at its column in the count
// rows (4 per-chunk 8-bit VALID counts per int32).  Validity within a
// chunk is a prefix (see pack_cycle_tc), so the first count[k] dibits of
// chunk k are the valid ones.
int64_t chan_feed_sb(const Fleet* f, FleetChan* c, int64_t chan,
                     const int32_t* sym, const int32_t* cnt,
                     int64_t n_chunks, int64_t strideC,
                     uint8_t* t5, int64_t* meta, int64_t row, int64_t cap) {
  int64_t nbits = 0;
  for (int64_t k = 0; k < n_chunks; k++) {
    uint32_t cw = (uint32_t)cnt[(k >> 2) * strideC];
    nbits += 2 * (int64_t)((cw >> (8 * (k & 3))) & 0xFF);
  }
  if (nbits == 0) return row;
  chan_make_space(c, nbits);
  uint8_t* w = c->buf + c->buf_len;
  for (int64_t k = 0; k < n_chunks; k++) {
    uint32_t cw = (uint32_t)cnt[(k >> 2) * strideC];
    int64_t nv = (int64_t)((cw >> (8 * (k & 3))) & 0xFF);
    uint32_t w0 = (uint32_t)sym[(2 * k) * strideC];
    uint32_t w1 = (uint32_t)sym[(2 * k + 1) * strideC];
    for (int64_t s = 0; s < nv; s++) {
      uint32_t d = (s < 16 ? (w0 >> (2 * s)) : (w1 >> (2 * (s - 16)))) & 3u;
      *w++ = (uint8_t)((d >> 1) & 1);
      *w++ = (uint8_t)(d & 1);
    }
  }
  c->buf_len += nbits;
  return chan_consume(f, c, chan, t5, meta, row, cap);
}

// per-channel dispatch of decoded blocks: the macparse_dispatch logic with
// deltas applied DIRECTLY to this channel's persistent display/cell state
// (mirrors rx/lower_mac.LowerMac._dispatch_native + its Python post-pass)
void chan_dispatch(FleetChan* c, int64_t* scramb, const uint8_t* type1,
                   const uint8_t* ok, const int64_t* meta,
                   const int64_t* rows, int64_t nrows, int64_t have_voice,
                   int64_t have_half, uint8_t* actions, int64_t* times) {
  MacState* st = &c->mac;
  Disp* d = &c->disp;
  bool resync = false;
  TTime base{};
  int64_t base_idx = 0;
  for (int64_t r = 0; r < nrows; r++) {
    int64_t i = rows[r];
    const int64_t* m = meta + i * META_COLS;
    // unpack the row's type-1 bits (the decode returns them bit-packed)
    uint8_t b[T1P_BYTES * 8];
    {
      const uint8_t* pb = type1 + i * T1P_BYTES;
      for (int64_t k = 0; k < T1P_BYTES * 8; k++)
        b[k] = (pb[k >> 3] >> (7 - (k & 7))) & 1;
    }
    int64_t bt = m[1], bnum = m[2], sidx = m[3];
    int64_t oki = ok[i];
    TTime t{m[7], m[6], m[5], m[4], m[8]};
    if (resync && sidx > base_idx) {
      t = base;
      add_tn_serial(&t, sidx - base_idx);
    }
    int64_t* tout = times + i * 5;
    tout[0] = t.hn; tout[1] = t.mn; tout[2] = t.fn; tout[3] = t.tn;
    tout[4] = t.sn;
    actions[i] = 0;
    d->curr_multiframe = t.mn;
    d->curr_frame = t.fn;
    int64_t tc = (m[9] == TS_SYNC_ID)     ? 3
                 : (m[9] == TS_NORM_2_ID) ? 2
                                          : (st->is_traffic ? 4 : 1);
    d->timeslot_content[((t.tn - 1) % 4 + 4) % 4] = tc;
    bool is_voice_slot = (bt == T_SCH_F && st->is_traffic);
    if (oki) c->crc_oks++;
    else if (!is_voice_slot) c->crc_fails++;
    int64_t nb = (bt == T_SB1) ? 60 : (bt == T_BBK) ? 14
                 : (bt == T_SCH_F) ? 268 : 124;
    int64_t lchan = 0;  // LC_UNKNOWN
    if (bt == T_SB1) {
      d->mcc = (int64_t)peek(b, nb, 31, 10);
      d->mnc = (int64_t)peek(b, nb, 41, 14);
      d->cc = (int64_t)peek(b, nb, 4, 6);
      if (oki) {
        c->cell_cc = d->cc;
        c->cell_time.tn = (int64_t)peek(b, nb, 10, 2) + 1;
        c->cell_time.fn = norm_field((int64_t)peek(b, nb, 12, 5), 18);
        c->cell_time.mn = norm_field((int64_t)peek(b, nb, 17, 6), 60);
        c->cell_mcc = d->mcc;
        c->cell_mnc = d->mnc;
        *scramb = ((((c->cell_cc & 0x3F) | ((c->cell_mnc & 0x3FFF) << 6)
                     | ((c->cell_mcc & 0x3FF) << 20)) << 2) | 3);
        c->scramb_init = *scramb;
        // PHY time resync + batch-lag correction (rx/lower_mac.py:77-87)
        int64_t lag = c->slot_count - sidx;
        c->time.tn = c->cell_time.tn;
        c->time.fn = c->cell_time.fn;
        c->time.mn = c->cell_time.mn;
        if (lag > 0) add_tn_serial(&c->time, lag);
        base = TTime{c->cell_time.hn, c->cell_time.mn, c->cell_time.fn,
                     c->cell_time.tn, c->cell_time.sn};
        base_idx = sidx;
        resync = true;
        d->last_crc_fail = 0;
      } else {
        d->last_crc_fail = 1;
      }
      lchan = LC_BSCH;
    } else if (bt == T_BBK) {
      lchan = LC_AACH;
    } else if (bt == T_SB2) {
      lchan = (t.fn == 18 && t.tn == 4 - ((t.mn + 3) % 4)) ? 11 : 0;  // BNCH
      d->last_crc_fail = oki ? 0 : 1;
    } else if (bt == T_SCH_F) {
      lchan = 1;  // LC_SCH_F
      if (oki) d->last_crc_fail = 0;
      if (st->is_traffic && have_voice) actions[i] = 1;
    } else if (bt == T_NDB) {
      if (st->is_traffic && bnum == 1) st->blk1_stolen = 1;
      if (st->is_traffic && bnum == 2 && st->blk1_stolen &&
          !st->blk2_stolen) {
        if (have_half) actions[i] = 2;
        continue;
      }
      d->last_crc_fail = oki ? 0 : 1;
    } else {
      d->last_crc_fail = oki ? 0 : 1;
    }
    if (!oki) continue;
    uint64_t seen = 0;
    receive_core(st, b, nb, lchan, t.tn, t.fn, &seen);
    if (seen & (1ull << 20)) {
      const Aach* a = &st->aach;
      if (a->have1) { d->access1_code = 'A' + a->code1; d->access1 = a->val1; }
      if (a->have2) { d->access2_code = 'A' + a->code2; d->access2 = a->val2; }
      if (a->have_dl) d->dl_usage = a->dl;
      if (a->have_ul) d->ul_usage = a->ul;
    }
    if (seen & (1ull << 21)) {
      d->dl_freq = st->si.dl_freq;
      d->ul_freq = st->si.ul_freq;
      for (int64_t k = 0, j = 0; k < 12; k++) {
        if (k == 3) continue;  // BS_SERVICE_FLAGS has a reserved slot
        d->flags[j++] = (st->si.bs_service_details >> k) & 1;
      }
      if (!st->si.cck_valid_no_hf)
        d->curr_hyperframe = st->si.hyperframe_number;
    }
  }
}

}  // namespace

extern "C" {

Fleet* fleet_create(int64_t C, const uint8_t* y, int64_t ylen,
                    const uint8_t* n, int64_t nlen, const uint8_t* p,
                    int64_t plen, int64_t scramb_default) {
  Fleet* f = new Fleet();
  f->C = C;
  f->scramb_default = scramb_default;
  f->ylen = ylen; f->nlen = nlen; f->plen = plen;
  std::memcpy(f->y, y, (size_t)ylen);
  std::memcpy(f->n, n, (size_t)nlen);
  std::memcpy(f->p, p, (size_t)plen);
  f->ch = new FleetChan[C]();
  f->scramb = new int64_t[C];
  for (int64_t c = 0; c < C; c++) {
    f->ch[c].time = TTime{0, 1, 1, 1, 1};       // TdmaTime defaults
    f->ch[c].cell_time = TTime{0, 1, 1, 1, 1};
    f->ch[c].scramb_init = scramb_default;
    f->ch[c].ks_scramb = -1;
    f->scramb[c] = scramb_default;
  }
  return f;
}

// Enable the local BBK decode: parity = RM3014_PARITY (14 x 16 row-major
// bits, params.py), scramb_tapmask = OR of 1 << (32 - t) over SCRAMB_TAPS.
// Builds the weight<=3 syndrome table (4526 correctable patterns; d=8
// guarantees collision-free syndromes inside that radius).
void fleet_set_rm(Fleet* f, const uint8_t* parity, uint64_t scramb_tapmask) {
  for (int i = 0; i < 14; i++) {
    uint16_t row = 0;
    for (int j = 0; j < 16; j++)
      if (parity[i * 16 + j]) row |= (uint16_t)(1u << j);
    f->rm_rows[i] = row;
  }
  f->scramb_tapmask = scramb_tapmask;
  uint16_t pos_syn[30];
  for (int i = 0; i < 14; i++) pos_syn[i] = f->rm_rows[i];
  for (int j = 0; j < 16; j++) pos_syn[14 + j] = (uint16_t)(1u << j);
  for (int64_t s = 0; s < (1 << 16); s++) f->rm_syn[s] = ~0u;
  f->rm_syn[0] = 0;
  for (int a = 0; a < 30; a++) {
    f->rm_syn[pos_syn[a]] = 1u << a;
    for (int b = a + 1; b < 30; b++) {
      uint16_t sab = (uint16_t)(pos_syn[a] ^ pos_syn[b]);
      f->rm_syn[sab] = (1u << a) | (1u << b);
      for (int c = b + 1; c < 30; c++)
        f->rm_syn[sab ^ pos_syn[c]] = (1u << a) | (1u << b) | (1u << c);
    }
  }
  f->rm_ready = true;
}

// Re-decode BBK rows under NEW scrambling codes (Python's scrambling-
// adoption redo): t5p = (n, 54) bit-packed type-5 rows (first 30 bits are
// the BBK block), scrambs (n,), out (n,) = info14 | ok << 14.
void fleet_rm_redecode(Fleet* f, const uint8_t* t5p, const int64_t* scrambs,
                       int64_t n, int64_t* out) {
  int64_t last_scramb = -1;
  uint8_t ks[30];
  for (int64_t r = 0; r < n; r++) {
    if (scrambs[r] != last_scramb) {
      gen_keystream((uint64_t)scrambs[r], f->scramb_tapmask, ks, 30);
      last_scramb = scrambs[r];
    }
    uint8_t bits[30];
    const uint8_t* pb = t5p + r * T5P_BYTES;
    for (int k = 0; k < 30; k++)
      bits[k] = (uint8_t)((pb[k >> 3] >> (7 - (k & 7))) & 1);
    out[r] = rm_decode_local(f, bits, ks);
  }
}

void fleet_destroy(Fleet* f) {
  delete[] f->ch;
  delete[] f->scramb;
  delete f;
}

int64_t fleet_chan_size() { return (int64_t)sizeof(FleetChan); }
void* fleet_chan_ptr(Fleet* f, int64_t c) { return &f->ch[c]; }
void* fleet_scramb_ptr(Fleet* f) { return f->scramb; }

// (C, T) dibits+valid -> type-5 rows + meta; returns row count (may exceed
// cap: caller must check and re-call with a larger buffer).  Sizing: a call
// can drain a full FLEET_BUFCAP ring backlog per channel ON TOP of the fed
// bits, so cap must be >= C * ((T*2 + FLEET_BUFCAP)/510 + 2) * 3 -- the
// backlog-inclusive formula FleetEngine.process_packed_cycles uses.
// Channel-partitioned parallel driver: worker w owns channels
// [w*C/n, (w+1)*C/n) and a proportional REGION of the output row buffer
// (the cap formulas are per-channel-linear, so an even channel split gets
// proportional capacity).  After the join the regions compact left into
// the dense layout the sequential path emits.  Row ORDER across channels
// differs from sequential, which is immaterial: per-channel rows stay
// chronological and every consumer either re-sorts stably by channel
// (FleetEngine._decode_dispatch) or groups by channel (fleet_dispatch).
static int64_t run_partitioned(
    const Fleet* f, uint8_t* t5, int64_t* meta, int64_t cap,
    const std::function<int64_t(int64_t, int64_t, uint8_t*, int64_t*,
                                int64_t)>& body) {
  int64_t n = f->nthreads;
  if (n > f->C) n = f->C;
  if (n <= 1) return body(0, f->C, t5, meta, cap);
  std::vector<int64_t> counts(n);
  std::vector<std::thread> ws;
  // region size proportional to the worker's CHANNEL count (the cap
  // formulas are per-channel-linear; an uneven split must not starve the
  // worker holding the extra channel)
  for (int64_t w = 0; w < n; w++)
    ws.emplace_back([&, w]() {
      int64_t c0 = w * f->C / n, c1 = (w + 1) * f->C / n;
      int64_t r0 = c0 * cap / f->C, r1 = c1 * cap / f->C;
      counts[w] =
          body(c0, c1, t5 + r0 * T5P_BYTES, meta + r0 * META_COLS, r1 - r0);
    });
  for (auto& t : ws) t.join();
  // a worker that overflowed its region returns count > region size with
  // the excess rows unwritten (the emit guard stops at cap): propagate
  // the overflow signal so the Python-side capacity assert fires instead
  // of compacting a short region as if complete
  for (int64_t w = 0; w < n; w++) {
    int64_t c0 = w * f->C / n, c1 = (w + 1) * f->C / n;
    if (counts[w] > c1 * cap / f->C - c0 * cap / f->C) return cap + 1;
  }
  int64_t row = counts[0];
  for (int64_t w = 1; w < n; w++) {
    int64_t r0 = (w * f->C / n) * cap / f->C;
    if (row != r0) {
      std::memmove(t5 + row * T5P_BYTES, t5 + r0 * T5P_BYTES,
                   (size_t)(counts[w] * T5P_BYTES));
      std::memmove(meta + row * META_COLS, meta + r0 * META_COLS,
                   (size_t)(counts[w] * META_COLS) * sizeof(int64_t));
    }
    row += counts[w];
  }
  return row;
}

int64_t fleet_feed(Fleet* f, const uint8_t* packed, int64_t T, uint8_t* t5,
                   int64_t* meta, int64_t cap) {
  // Large superblocks (wb_k deep) can carry more bits per call than the
  // per-channel ring holds (FLEET_BUFCAP); feed each channel in slices
  // small enough that a slice always fits after the oldest-bit drop, and
  // let the state machine consume between slices.  Equivalent to feeding
  // smaller chunks (pinned by the superblock batching-equivalence test);
  // without this a worst-case slice overran c->buf.
  const int64_t TSEG = FLEET_BUFCAP / 4;  // 2 bits/slot worst case
  return run_partitioned(
      f, t5, meta, cap,
      [&](int64_t c0, int64_t c1, uint8_t* t5w, int64_t* metaw,
          int64_t capw) {
        int64_t row = 0;
        for (int64_t c = c0; c < c1; c++)
          for (int64_t t0 = 0; t0 < T; t0 += TSEG) {
            int64_t seg = T - t0 < TSEG ? T - t0 : TSEG;
            row = chan_feed(f, &f->ch[c], c, packed + c * T + t0, seg, t5w,
                            metaw, row, capw);
          }
        return row;
      });
}

// TIME-MAJOR superblock feed (rx/receiver.pack_cycle_tc layout): w is
// (K*G, C) int32, cycle-major, where each cycle's G = n_chunks*2 symbol
// rows followed by ceil(n_chunks/4) count rows.  Equivalent to K
// fleet_feed calls on the unpacked channel-major bytes; rows come out in
// (cycle, channel) order -- the Python caller re-sorts channel-major as it
// does for process_packed_cycles.  Same cap rule as fleet_feed.
int64_t fleet_feed_sb(Fleet* f, const int32_t* wds, int64_t K,
                      int64_t n_chunks, uint8_t* t5, int64_t* meta,
                      int64_t cap) {
  const int64_t sym_words = n_chunks * 2;
  const int64_t cnt_words = (n_chunks + 3) / 4;
  const int64_t G = sym_words + cnt_words;
  // segment so one slice never exceeds the ring (64 bits/chunk worst case)
  const int64_t KSEG = FLEET_BUFCAP / 128;
  return run_partitioned(
      f, t5, meta, cap,
      [&](int64_t c0, int64_t c1, uint8_t* t5w, int64_t* metaw,
          int64_t capw) {
        int64_t row = 0;
        // cycle j stays OUTER within the worker: each channel's rows come
        // out chronological, exactly as the sequential path emits them
        for (int64_t j = 0; j < K; j++)
          for (int64_t c = c0; c < c1; c++)
            for (int64_t k0 = 0; k0 < n_chunks; k0 += KSEG) {
              int64_t seg = n_chunks - k0 < KSEG ? n_chunks - k0 : KSEG;
              const int32_t* base = wds + j * G * f->C + c;
              // count pointer for chunk k = cnt[(k >> 2) * C]: offset the
              // base so in-segment chunk indices stay 0-based multiples
              // of 4
              row = chan_feed_sb(f, &f->ch[c], c, base + (2 * k0) * f->C,
                                 base + (sym_words + (k0 >> 2)) * f->C,
                                 seg, f->C, t5w, metaw, row, capw);
            }
        return row;
      });
}

// decoded rows -> per-channel MAC dispatch.  Rows are channel-major (as
// fleet_feed emits them); `actions` returns deferred voice work per row
// (1 = full traffic slot, 2 = surviving half of a stolen slot).
void fleet_dispatch(Fleet* f, const uint8_t* type1, const uint8_t* ok,
                    const int64_t* meta, int64_t nrows, int64_t have_voice,
                    int64_t have_half, uint8_t* actions, int64_t* times) {
  // rows of one channel are contiguous (meta[:,0] is nondecreasing);
  // dispatch channel segment [i0, i1) on this thread's scratch list
  auto run_span = [&](int64_t i0, int64_t i1) {
    static thread_local std::vector<int64_t> rows;
    if ((int64_t)rows.size() < i1 - i0) rows.resize(i1 - i0);
    int64_t i = i0;
    while (i < i1) {
      int64_t chan = meta[i * META_COLS];
      int64_t k = 0;
      while (i < i1 && meta[i * META_COLS] == chan) rows[k++] = i++;
      chan_dispatch(&f->ch[chan], &f->scramb[chan], type1, ok, meta,
                    rows.data(), k, have_voice, have_half, actions, times);
    }
  };
  int64_t n = f->nthreads;
  if (n <= 1 || nrows < 2 * n) {
    run_span(0, nrows);
    return;
  }
  // split at channel boundaries near the even row split (channels are
  // independent; per-row outputs are disjoint)
  std::vector<int64_t> cuts{0};
  for (int64_t w = 1; w < n; w++) {
    int64_t i = w * nrows / n;
    while (i > cuts.back() &&
           meta[i * META_COLS] == meta[(i - 1) * META_COLS])
      i--;                     // back up to this channel's first row
    if (i > cuts.back()) cuts.push_back(i);
  }
  cuts.push_back(nrows);
  std::vector<std::thread> ws;
  for (size_t w = 0; w + 1 < cuts.size(); w++)
    ws.emplace_back(run_span, cuts[w], cuts[w + 1]);
  for (auto& t : ws) t.join();
}

// Enable the per-channel worker pool (0 = hardware concurrency).  The
// per-channel loops are embarrassingly parallel; Python's ctypes calls
// release the GIL, so workers use real cores even under one interpreter.
void fleet_set_threads(Fleet* f, int64_t n) {
  if (n <= 0) n = (int64_t)std::thread::hardware_concurrency();
  f->nthreads = n < 1 ? 1 : n;
}

}  // extern "C"
