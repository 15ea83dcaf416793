// The batched ACELP synthesis of acelp_synth.cu: the host codec's decoder
// (csrc/host/acelp_codec.cpp, tetra_acelp_decode_frame) for one call, its
// items in order, on one warp.  Written once for two builds:
//
// - nvcc (__CUDACC__): a warp per call.  SYN_LANES(i, n) spreads i
//   over the lanes, SYN_LANE0 runs a block on lane 0, SYN_SYNC() is
//   __syncwarp();
// - g++ (tests/acelp_synth_check.cpp): the same code with one lane that
//   takes every i in turn, so the CPU tests hold this arithmetic to the
//   host codec bit for bit.  A phase that reads what other lanes write
//   (the adaptive codebook's chunks) reads all, then writes all, as the
//   warp does, and counts in chunk_faults each read of its own chunk.
//
// Every float the codec forms is formed by the same operations in the
// same order: each recursion (synthesis and postfilter IIRs, the highpass
// biquad, a subframe's postfilter impulse response) and each sum runs on
// one lane in the codec's order; what is spread over lanes is elementwise
// (the adaptive codebook within a chunk, the algebraic code, the
// postfilter's numerator FIR, the tilt and gain, the output conversion)
// or independent (the 40 cosf of a frame's four LPC conversions, its
// eight polynomial products, its four subframes' postfilter terms, each
// on its own lane in the codec's order).
// cosf and expf are glibc's (acelp_libm.cuh); sqrtf and division are
// IEEE (no fast math); no multiply-add is contracted (-fmad=false).

#pragma once

#include <stdint.h>

#include "acelp_libm.cuh"

#ifdef __CUDACC__
#define SYN_FN __device__ inline
#define SYN_LANES(i, n) for (int i = lane; i < (n); i += 32)
#define SYN_LANE0 if (lane == 0)
#define SYN_SYNC() __syncwarp()
#else
#include <cmath>
#define SYN_FN inline
#define SYN_LANES(i, n) for (int i = 0; i < (n); ++i)
#define SYN_LANE0 if (true)
#define SYN_SYNC() ((void)0)
#endif

namespace acelp_synth {

#ifndef __CUDACC__
inline int chunk_faults = 0;     // host build: chunk reads of the chunk
#endif

constexpr int LPC_ORDER = 10;
constexpr int FRAME = 240;
constexpr int SUBFRAME = 60;
constexpr int NSUB = 4;
constexpr int FRAME_BITS = 137;
constexpr int PITCH_MAX = 147;
constexpr int LAG2_MIN = 40;
constexpr int LAG2_MAX = 2 * PITCH_MAX + 1;
constexpr int EXC_PAD = 4;
constexpr int HIST = PITCH_MAX + EXC_PAD;      // excitation history: 151
constexpr int EXC_LEN = HIST + FRAME;          // 391

// One call's decoder: the codec's DecoderState, field for field, and a
// flag set when the call's first synthesised item made it.
struct State {
  float lsf_prev[LPC_ORDER];
  float mem_syn[LPC_ORDER];
  float excitation[EXC_LEN];
  float pf_num[LPC_ORDER];
  float pf_den[LPC_ORDER];
  float tilt_mem, agc_gain;
  float hp_x1, hp_x2, hp_y1, hp_y2;
  float prev_pitch_gain, log_gc;
  int32_t prev_lag2;
  int32_t created;
};
constexpr int STATE_WORDS = sizeof(State) / 4;

// The codec's runtime quantizer tables (tetra_acelp_load_tables), as
// voice/acelp.load_codec_tables loaded them.
struct Tables {
  float cb1[256][3];
  float cb2[512][3];
  float cb3[512][4];
  float gain[64][2];
  float pred;
  int32_t n1, n2, n3, ng;
};

// A warp's workspace: its call's state and one frame's intermediates.
struct Work {
  double cs[NSUB][LPC_ORDER];       // -2 cos(lsf) of each subframe
  double pq[2 * NSUB][LPC_ORDER + 2];  // P(z)(1 + 1/z), Q(z)(1 - 1/z)
  State st;
  float lsf[LPC_ORDER];             // this frame's LSFs
  float a[NSUB][LPC_ORDER];         // LPC of each subframe
  float an[NSUB][LPC_ORDER];        // postfilter numerator A(z/gn)
  float ad[NSUB][LPC_ORDER];        // postfilter denominator A(z/gd)
  float mu[NSUB];                   // tilt of each subframe
  float syn[SUBFRAME];              // synthesis out, then postfilter out
  float tmp[SUBFRAME];              // postfilter FIR out, then biquad in
  float out[SUBFRAME];              // postfilter IIR out, then biquad out
  float scal;                       // a lane-0 scalar for every lane
};

// the uniform scalars of a call's decoder, kept in registers
struct Regs {
  float log_gc, prev_pitch_gain;
  int prev_lag2;
};

SYN_FN float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

SYN_FN float lsf_mean(int i) {
  const float m[LPC_ORDER] = {0.24f, 0.47f, 0.81f, 1.12f, 1.44f,
                              1.78f, 2.09f, 2.40f, 2.68f, 2.94f};
  return m[i];
}

// The frame's 137 bits, MSB first: bit p is bit 31 - p % 32 of word p / 32.
struct Bits {
  uint32_t w[6];
  // the n-bit field at pos (n <= 16), the codec's BitReader::take
  SYN_FN int take(int pos, int n) const {
    uint64_t two = ((uint64_t)w[pos >> 5] << 32) | w[(pos >> 5) + 1];
    return (int)((two >> (64 - (pos & 31) - n)) & ((1u << n) - 1));
  }
};

SYN_FN Bits load_bits(const uint8_t *bits, int lane) {
  Bits b;
#ifdef __CUDACC__
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    int p = 32 * k + lane;
    unsigned v = p < FRAME_BITS ? (bits[p] & 1) : 0;
    b.w[k] = __brev(__ballot_sync(0xffffffffu, v));
  }
#else
  (void)lane;
  for (int k = 0; k < 5; ++k) {
    b.w[k] = 0;
    for (int j = 0; j < 32; ++j)
      if (32 * k + j < FRAME_BITS)
        b.w[k] |= (uint32_t)(bits[32 * k + j] & 1) << (31 - j);
  }
#endif
  b.w[5] = 0;
  return b;
}

// lsf_order_enforce
SYN_FN void order_enforce(float *lsf) {
  const float min_gap = 0.035f;
#pragma unroll
  for (int i = 1; i < LPC_ORDER; i++)
    if (lsf[i] < lsf[i - 1] + min_gap) lsf[i] = lsf[i - 1] + min_gap;
#pragma unroll
  for (int i = LPC_ORDER - 1; i >= 0; i--)
    if (lsf[i] > 3.10f - (LPC_ORDER - 1 - i) * min_gap)
      lsf[i] = 3.10f - (LPC_ORDER - 1 - i) * min_gap;
}

// acb_sample
SYN_FN float acb_sample(const float *e, int i, int lag2) {
  const float taps[2 * EXC_PAD] = {-0.00732f, 0.03248f, -0.13735f, 0.61219f,
                                   0.61219f,  -0.13735f, 0.03248f, -0.00732f};
  const float *p = e + i - (lag2 >> 1);
  if ((lag2 & 1) == 0) return *p;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * EXC_PAD; k++) s += taps[k] * p[k - EXC_PAD];
  return s;
}

// the algebraic code's sample i of a 16-bit index (decode_algebraic)
SYN_FN float code_at(int index, int i) {
  int track = i / 15;
  int field = (index >> (track * 4)) & 0xF;
  if (i != 15 * track + 2 * (field >> 1)) return 0.0f;
  return (field & 1) ? -1.0f : 1.0f;
}

// A frame's four LPC conversions (lsf_to_lpc of each subframe's
// interpolated LSFs) and each subframe's postfilter coefficients and tilt
// (postfilter's an, ad, h, r0, r1, mu), from w.lsf and w.st.lsf_prev.
SYN_FN void lpc_phase(Work &w, int lane) {
  SYN_LANES(t, NSUB * LPC_ORDER) {
    int s = t / LPC_ORDER, j = t % LPC_ORDER;
    float wt = (s + 1) / (float)NSUB;
    float li = (1.0f - wt) * w.st.lsf_prev[j] + wt * w.lsf[j];
    w.cs[s][j] = -2.0 * (double)acelp_libm::glibc_cosf(li);
  }
  SYN_SYNC();
  // lane 2s + 0 builds subframe s's P(z) from the even LSFs, 2s + 1 its
  // Q(z) from the odd ones: products of (1 + c z^-1 + z^-2)
  SYN_LANES(t, 2 * NSUB) {
    int s = t >> 1, odd = t & 1;
    double P[16];
    P[0] = 1.0;
#pragma unroll
    for (int i = 0; i < LPC_ORDER / 2; i++) {
      const int n = 1 + 2 * i;
      double c = w.cs[s][2 * i + odd];
      double Pn[16];
#pragma unroll
      for (int j = 0; j < 16; j++) Pn[j] = 0.0;
#pragma unroll
      for (int j = 0; j < n; j++) {
        Pn[j] += P[j];
        Pn[j + 1] += c * P[j];
        Pn[j + 2] += P[j];
      }
#pragma unroll
      for (int j = 0; j < 16; j++) P[j] = Pn[j];
    }
    // Pf[j] += P[j]; Pf[j + 1] += P[j] (Qf: -= Q[j]), j < 11
    double F[16];
#pragma unroll
    for (int j = 0; j < 16; j++) F[j] = 0.0;
#pragma unroll
    for (int j = 0; j < LPC_ORDER + 1; j++) {
      F[j] += P[j];
      if (odd)
        F[j + 1] -= P[j];
      else
        F[j + 1] += P[j];
    }
#pragma unroll
    for (int j = 0; j < LPC_ORDER + 2; j++) w.pq[t][j] = F[j];
  }
  SYN_SYNC();
  SYN_LANES(t, NSUB * LPC_ORDER) {
    int s = t / LPC_ORDER, i = t % LPC_ORDER + 1;
    w.a[s][i - 1] = (float)(0.5 * (w.pq[2 * s][i] + w.pq[2 * s + 1][i]));
  }
  SYN_SYNC();
  SYN_LANES(s, NSUB) {
    const float gn = 0.65f, gd = 0.75f;
    float an[LPC_ORDER], ad[LPC_ORDER];
    float fn = gn, fd = gd;
#pragma unroll
    for (int j = 0; j < LPC_ORDER; j++) {
      float a = w.a[s][j];
      an[j] = a * fn;
      ad[j] = a * fd;
      fn *= gn;
      fd *= gd;
      w.an[s][j] = an[j];
      w.ad[s][j] = ad[j];
    }
    float h[22];
#pragma unroll
    for (int i = 0; i < 22; i++) {
      float v = (i == 0) ? 1.0f : ((i - 1 < LPC_ORDER) ? an[i - 1] : 0.0f);
#pragma unroll
      for (int j = 0; j < LPC_ORDER && j < i; j++) v -= ad[j] * h[i - 1 - j];
      h[i] = v;
    }
    float r0 = 1e-6f, r1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 22; i++) r0 += h[i] * h[i];
#pragma unroll
    for (int i = 0; i < 21; i++) r1 += h[i] * h[i + 1];
    float k1 = r1 / r0;
    w.mu[s] = (k1 > 0.0f) ? 0.5f * k1 : 0.25f * k1;
  }
  SYN_SYNC();
}

// a 10-tap all-pole recursion on lane 0: y[i] = x[i] - sum_j c[j] y[i-1-j]
// with mem[j] = y[-1-j], mem updated (synth_filter, the postfilter's IIR)
SYN_FN void iir10(const float *c, const float *x, float *y, float *mem) {
  float k[LPC_ORDER], m[LPC_ORDER];
#pragma unroll
  for (int j = 0; j < LPC_ORDER; j++) {
    k[j] = c[j];
    m[j] = mem[j];
  }
#pragma unroll 4
  for (int i = 0; i < SUBFRAME; i++) {
    float s = x[i];
#pragma unroll
    for (int j = 0; j < LPC_ORDER; j++) s -= k[j] * m[j];
#pragma unroll
    for (int j = LPC_ORDER - 1; j > 0; j--) m[j] = m[j - 1];
    m[0] = s;
    y[i] = s;
  }
#pragma unroll
  for (int j = 0; j < LPC_ORDER; j++) mem[j] = m[j];
}

// One subframe from its excitation on: the adaptive and algebraic
// codebooks, the runaway guard, synthesis, postfilter, highpass, s16.
SYN_FN void subframe(Work &w, Regs &r, const Tables *tab, int s, int lag2,
                     int alg, int gidx, bool bfi, int16_t *out, int lane) {
  State &st = w.st;
  float *e = st.excitation + HIST + s * SUBFRAME;
  // decode_gains: every lane alike
  float gp, gc;
  if (tab) {
    gp = tab->gain[gidx % tab->ng][0];
    gc = tab->gain[gidx % tab->ng][1];
  } else {
    int gpi = (gidx >> 3) & 7, gci = gidx & 7;
    gp = 1.2f * gpi / 7.0f;
    r.log_gc = 0.6f * r.log_gc + 0.4f * 5.5f + 0.35f * (gci - 3.5f);
    gc = acelp_libm::glibc_expf(clampf(r.log_gc, 0.0f, 9.0f));
  }
  if (bfi) {
    gp = r.prev_pitch_gain * 0.9f;
    gc = 0.0f;
  }
  // adaptive codebook in chunks that read only samples written before
  // the chunk: the half-sample taps reach lag - EXC_PAD + 3 back
  const int lag = lag2 >> 1;
  int chunk = (lag2 & 1) ? lag - EXC_PAD + 1 : lag;
  if (chunk > 32) chunk = 32;
  for (int c0 = 0; c0 < SUBFRAME; c0 += chunk) {
    int n = SUBFRAME - c0 < chunk ? SUBFRAME - c0 : chunk;
#ifdef __CUDACC__
    float v = 0.0f;
    if (lane < n) v = gp * acb_sample(e, c0 + lane, lag2);
    __syncwarp();
    if (lane < n) e[c0 + lane] = v;
    __syncwarp();
#else
    float v[32];
    for (int j = 0; j < n; j++) {
      int reach = c0 + j - lag + ((lag2 & 1) ? EXC_PAD - 1 : 0);
      chunk_faults += reach >= c0;
      v[j] = gp * acb_sample(e, c0 + j, lag2);
    }
    for (int j = 0; j < n; j++) e[c0 + j] = v[j];
#endif
  }
  SYN_LANES(i, SUBFRAME) e[i] += gc * code_at(alg, i);
  SYN_SYNC();
  // runaway guard
  SYN_LANE0 {
    float erms = 1e-6f;
    for (int i = 0; i < SUBFRAME; i++) erms += e[i] * e[i];
    w.scal = sqrtf(erms / SUBFRAME);
  }
  SYN_SYNC();
  const float erms = w.scal;
  const float exc_limit = 4096.0f;
  if (erms > exc_limit) {
    float sc = exc_limit / erms;
    SYN_LANES(i, SUBFRAME) e[i] *= sc;
    SYN_SYNC();
  }
  r.prev_pitch_gain = gp;
  r.prev_lag2 = lag2;
  // synthesis
  SYN_LANE0 iir10(w.a[s], e, w.syn, st.mem_syn);
  SYN_SYNC();
  // postfilter: numerator FIR over lanes, then the IIR on lane 0
  const float *an = w.an[s];
  SYN_LANES(i, SUBFRAME) {
    float v = w.syn[i];
#pragma unroll
    for (int j = 0; j < LPC_ORDER; j++) {
      float prev = (i - 1 - j) >= 0 ? w.syn[i - 1 - j] : st.pf_num[j - i];
      v += an[j] * prev;
    }
    w.tmp[i] = v;
  }
  SYN_SYNC();
  SYN_LANE0 {
    for (int j = 0; j < LPC_ORDER; j++) st.pf_num[j] = w.syn[SUBFRAME - 1 - j];
    iir10(w.ad[s], w.tmp, w.out, st.pf_den);
    float ein = 1e-6f, eout = 1e-6f;
    for (int i = 0; i < SUBFRAME; i++) {
      ein += w.syn[i] * w.syn[i];
      eout += w.out[i] * w.out[i];
    }
    float g = sqrtf(ein / eout);
    st.agc_gain = 0.9f * st.agc_gain + 0.1f * g;
  }
  SYN_SYNC();
  // tilt and gain over lanes; then the biquad's input terms
  const float mu = w.mu[s], agc = st.agc_gain;
  SYN_LANES(i, SUBFRAME) {
    float prev = i > 0 ? w.out[i - 1] : st.tilt_mem;
    w.syn[i] = (w.out[i] - mu * prev) * agc;
  }
  SYN_SYNC();
  const float b0 = 0.9446f, b1 = -1.8892f, b2 = 0.9446f;
  const float a1 = -1.8861f, a2 = 0.8923f;
  SYN_LANES(i, SUBFRAME) {
    float x1 = i > 0 ? w.syn[i - 1] : st.hp_x1;
    float x2 = i > 1 ? w.syn[i - 2] : (i == 1 ? st.hp_x1 : st.hp_x2);
    w.tmp[i] = b0 * w.syn[i] + b1 * x1 + b2 * x2;
  }
  SYN_SYNC();
  SYN_LANE0 {
    st.tilt_mem = w.out[SUBFRAME - 1];
    float y1 = st.hp_y1, y2 = st.hp_y2;
#pragma unroll 4
    for (int i = 0; i < SUBFRAME; i++) {
      float y = w.tmp[i] - a1 * y1 - a2 * y2;
      y2 = y1;
      y1 = y;
      w.out[i] = y;
    }
    st.hp_y1 = y1;
    st.hp_y2 = y2;
    st.hp_x1 = w.syn[SUBFRAME - 1];
    st.hp_x2 = w.syn[SUBFRAME - 2];
  }
  SYN_SYNC();
  SYN_LANES(i, SUBFRAME) {
    float v = clampf(w.out[i] * 8.0f, -32768.0f, 32767.0f);
    out[s * SUBFRAME + i] = (int16_t)(int)v;
  }
  SYN_SYNC();
}

// tetra_acelp_decode_frame: one 137-bit frame (bit per byte) into 240
// samples, bfi != 0 concealing it
SYN_FN void decode_frame(Work &w, Regs &r, const Tables *tab,
                         const uint8_t *bits, bool bfi, int16_t *out,
                         int lane) {
  State &st = w.st;
  float lsf[LPC_ORDER];
  int lag2[NSUB], alg[NSUB], gains[NSUB];
  if (!bfi) {
    const Bits b = load_bits(bits, lane);
    if (tab) {
      const float *v1 = tab->cb1[b.take(0, 8) % tab->n1];
      const float *v2 = tab->cb2[b.take(8, 9) % tab->n2];
      const float *v3 = tab->cb3[b.take(17, 9) % tab->n3];
#pragma unroll
      for (int i = 0; i < 3; i++) lsf[i] = tab->pred * st.lsf_prev[i] + v1[i];
#pragma unroll
      for (int i = 0; i < 3; i++)
        lsf[3 + i] = tab->pred * st.lsf_prev[3 + i] + v2[i];
#pragma unroll
      for (int i = 0; i < 4; i++)
        lsf[6 + i] = tab->pred * st.lsf_prev[6 + i] + v3[i];
    } else {
      const int width[LPC_ORDER] = {3, 3, 2, 3, 3, 3, 2, 2, 2, 3};
      const float LSF_PRED = 0.65f, LSF_SPAN = 0.25f;
      int pos = 0;
#pragma unroll
      for (int i = 0; i < LPC_ORDER; i++) {
        int q = b.take(pos, width[i]);
        pos += width[i];
        int levels = 1 << width[i];
        float delta = LSF_SPAN * (2.0f * q / (levels - 1) - 1.0f);
        float m = lsf_mean(i);
        lsf[i] = (m + LSF_PRED * (st.lsf_prev[i] - m)) + delta;
      }
    }
    order_enforce(lsf);
    const int at[NSUB] = {26, 56, 83, 110};
#pragma unroll
    for (int s = 0; s < NSUB; s++) {
      if (s == 0) {
        lag2[0] = LAG2_MIN + b.take(26, 8);
      } else {
        int v = lag2[s - 1] + b.take(at[s], 5) - 15;
        lag2[s] = v < LAG2_MIN ? LAG2_MIN : (v > LAG2_MAX ? LAG2_MAX : v);
      }
      int p = at[s] + (s == 0 ? 8 : 5);
      alg[s] = b.take(p, 16);
      gains[s] = b.take(p + 16, 6);
    }
  } else {
#pragma unroll
    for (int i = 0; i < LPC_ORDER; i++) lsf[i] = st.lsf_prev[i];
#pragma unroll
    for (int s = 0; s < NSUB; s++) {
      lag2[s] = r.prev_lag2;
      alg[s] = 0;
      gains[s] = 0;
    }
  }
  SYN_LANE0 {
#pragma unroll
    for (int i = 0; i < LPC_ORDER; i++) w.lsf[i] = lsf[i];
  }
  SYN_SYNC();
  lpc_phase(w, lane);
#pragma unroll 1
  for (int s = 0; s < NSUB; s++)
    subframe(w, r, tab, s, lag2[s], alg[s], gains[s], bfi, out, lane);
  // roll the excitation history, remember the LSFs
  SYN_LANES(i, HIST) st.excitation[i] = st.excitation[FRAME + i];
  SYN_LANES(i, LPC_ORDER) st.lsf_prev[i] = w.lsf[i];
  SYN_SYNC();
}

// tetra_acelp_create's state, made in the workspace
SYN_FN void create(Work &w, Regs &r, int lane) {
  SYN_LANES(i, STATE_WORDS) ((uint32_t *)&w.st)[i] = 0u;
  SYN_SYNC();
  SYN_LANE0 {
    for (int i = 0; i < LPC_ORDER; i++) w.st.lsf_prev[i] = lsf_mean(i);
    w.st.agc_gain = 1.0f;
    w.st.created = 1;
  }
  SYN_SYNC();
  r.log_gc = 5.5f;
  r.prev_pitch_gain = 0.0f;
  r.prev_lag2 = 120;
}

// The items order[lo..hi) of one call, in time order, on its decoder
// `g` (decode_item of acelp_batch.cpp): kind 0 both frames, 1 240 samples
// of silence then frame 2, any other 480 samples of silence and the
// decoder untouched.  A decoder not yet made is made on the call's first
// item that is not withheld.
SYN_FN void run_call(Work &w, State *g, const int32_t *order, int lo,
                     int hi, const uint8_t *frames, const uint8_t *bfi,
                     const int8_t *kind, const Tables *tab, int16_t *pcm,
                     int lane) {
  SYN_LANES(i, STATE_WORDS) ((uint32_t *)&w.st)[i] = ((const uint32_t *)g)[i];
  SYN_SYNC();
  Regs r{w.st.log_gc, w.st.prev_pitch_gain, w.st.prev_lag2};
  bool made = w.st.created != 0;
  for (int j = lo; j < hi; j++) {
    const int it = order[j];
    const int k = kind[it];
    int16_t *out = pcm + (int64_t)it * 2 * FRAME;
    if (k != 0 && k != 1) {
      SYN_LANES(i, 2 * FRAME) out[i] = 0;
      continue;
    }
    if (!made) {
      create(w, r, lane);
      made = true;
    }
    const uint8_t *f = frames + (int64_t)it * 2 * FRAME_BITS;
    if (k == 0)
      decode_frame(w, r, tab, f, bfi[2 * it] != 0, out, lane);
    else
      SYN_LANES(i, FRAME) out[i] = 0;
    decode_frame(w, r, tab, f + FRAME_BITS, bfi[2 * it + 1] != 0,
                 out + FRAME, lane);
  }
  if (!made) return;
  SYN_LANE0 {
    w.st.log_gc = r.log_gc;
    w.st.prev_pitch_gain = r.prev_pitch_gain;
    w.st.prev_lag2 = r.prev_lag2;
  }
  SYN_SYNC();
  SYN_LANES(i, STATE_WORDS) ((uint32_t *)g)[i] = ((const uint32_t *)&w.st)[i];
}

}  // namespace acelp_synth
