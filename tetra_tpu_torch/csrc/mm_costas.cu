// K2: chunked ML timing recovery + Costas + pi/4-DQPSK differential slicer
// (stage 2 of the demod).
//
// Replaces the TPU kernel tetra_tpu/ops/mm_pallas.py:mm_costas.  Mosaic has
// no vector gather, so that kernel cut a window per 128-lane tile and
// aligned every channel with a barrel shifter plus 0/1 selection matmuls.
// Here a lane reads the 8 interpolator taps mf[ipos + t] directly from the
// [tail(7) | mf(T)] stream.  Per group of G symbols (G = 64: two K_SYM
// chunks, pair mode; G = 32 for an odd chunk count), with the loop state
// frozen over the group (semantics: tetra_tpu_torch/ops/mm_kernel.
// mm_costas_plain):
//
//   p = pos + omega k;  ipos = floor(p);  mu = p - ipos;  valid = ipos < T
//   f0, d = sum_t Horner_t(mu) x[ipos + t]      (degree-5 polys, value + d/dmu)
//   err = clip(sgn(f0r) dr + sgn(f0i) di, +-4)  (masked by valid)
//   omega <- clip(omega + om_g sum err);  pos <- pos + omega n_valid + mu_g sum err
//   s = f0 * exp(j(ph2 - pi/4 - cphase + k(-pi/4 - cfreq)))  (rotator recurrence)
//   cerr = clip(sgn(sr) si - sgn(si) sr, +-1); rail-gated leaky cfreq; cphase wrap
//   quad -> differential dibit (remap {0,1,2,3} -> {0,1,3,2}); |sin| dist proxy
//
// valid is ipos < T only: the TPU kernel's extra reachability gate (offset
// from the tile's minimum < 512) existed for the barrel shifter and is not
// ported (ROADMAP Queue 3).
//
// What bounds it on the card.  The bytes (mf in, dibits/valid/dist out,
// ~16.9 MB at C = 256, T = 4608) take ~5 us, the ~0.17 GFLOP ~2.5 us; the 38
// groups of a channel run in series, so one group's latency times 38 bounds
// it unless the channels fill the card.  Design (chip_smoke.py times it):
//   * one warp per channel, the group's symbols across lanes (lane l takes
//     k = l and, in pair mode, l + 32): the symbols of a group are
//     independent once the loop state is frozen.  The valid count is a
//     ballot; err_sum and cerr_sum add the terms in symbol order,
//     the order of the first port of this kernel, so the kernel is
//     bit-identical to it (the loops amplify last-bit differences, and the
//     card check's warm-up trajectory stays the one its limits were set on).
//     Every lane forms the same sums and runs the same group-end update
//     (timing, rail-gated leaky Costas, wraps, ph2): the state needs no
//     broadcast;
//   * the window of rows a group reads, [min pos, max pos + omega (G-1) + 8)
//     over the block's channels, is staged in shared memory by coalesced
//     cp.async copies (each 32-byte row sector holds the block's 8
//     channels), in flight while the group's Costas constants are
//     computed, and the taps are read from there; the next group's rows
//     are prefetched into L2 meanwhile.  Read directly, each tap would use
//     one 4-byte word of a 32-byte sector.  A window wider than WMAX rows
//     (channels whose timing has drifted far apart) falls back to direct
//     loads from device memory for that group;
//   * the kernel is instantiated for 1 or 2 symbols per lane, so the
//     symbol loop and the tap loads are straight-line code;
//   * the previous group's output rows are stored while this group's
//     window copies are in flight;
//   * the differential chain takes the previous quad from __shfl_up_sync
//     (prev_sym for k = 0, lane 31's first-half quad for k = 32);
//   * the Costas rotator's cos/sin (of r_ph, 8 r_fr and r_fr) and the
//     squared twiddles of every doubling level are computed once per group;
//     each lane then runs the same doubling products from them as rot_ramp;
//   * WPB = 8 adjacent channels per block (C = 256: 32 blocks);
//   * outputs go through shared memory (double-buffered) and are stored as
//     rows of the block's 8 channels; two block barriers per group (window
//     staged; outputs and the next window's bounds ready);
//   * the interpolator polynomials are kernel parameters (constant bank).
// No tensor cores: per symbol a degree-5 Horner per tap and an 8-tap dot.
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

#define NTAPS 8
#define NPOLY 6
#define WPB 8      // channels (one warp each) per block
#define GMAX 64
#define WMAX 320   // staged window rows (a pair-mode group needs ~140)

struct K2Polys {
  float b[NPOLY][NTAPS];  // fractional-delay bank, highest power first
  float d[NPOLY][NTAPS];  // its derivative
};

__device__ __forceinline__ float sgnf(float v) { return v > 0.0f ? 1.0f : -1.0f; }

__device__ __forceinline__ void rot_by(float &c, float &s, float wc, float ws) {
  float cn = c * wc - s * ws;
  float sn = s * wc + c * ws;
  c = cn;
  s = sn;
}

__device__ __forceinline__ void prefetch_l2(const float *p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ const float *stream_row(const float *tail,
                                                   const float *mf, int e,
                                                   int C) {
  // row e of the [tail(7) | mf(T)] stream
  return e < NTAPS - 1 ? tail + (size_t)e * C : mf + (size_t)(e - (NTAPS - 1)) * C;
}

__device__ __forceinline__ void group_rows(float pos, float omega, int G, int T,
                                           int &lo, int &hi) {
  // stream rows [lo, hi) the group's symbols read: ipos never decreases
  // with k, so the first and last symbols bound them
  int i0 = (int)floorf(pos + omega * 0.0f);
  int i1 = (int)floorf(pos + omega * (float)(G - 1));
  lo = min(max(i0, 0), T - 1);
  hi = min(max(i1, 0), T - 1) + NTAPS;
}

template <int H>  // symbols per lane: 2 in pair mode (G = 64), else 1
__global__ void __launch_bounds__(32 * WPB)
mm_costas_kernel(const float *__restrict__ mfr, const float *__restrict__ mfi,
                 const float *__restrict__ tail_r,
                 const float *__restrict__ tail_i,
                 const float *__restrict__ st0, const K2Polys poly,
                 float *__restrict__ sym_r, float *__restrict__ sym_i,
                 int *__restrict__ dib, int *__restrict__ val,
                 float *__restrict__ dist, float *__restrict__ st_out, int T,
                 int C, int n_groups, float mu_g, float om_g,
                 float omega_min, float omega_max, float ca_g, float cb_g,
                 float clim, float leak_th, float pi4) {
  __shared__ float s_dph2[GMAX + 1];
  __shared__ float win_r[WMAX][WPB + 1], win_i[WMAX][WPB + 1];  // padded rows
  __shared__ int s_lo[2][WPB], s_hi[2][WPB];
  __shared__ float2 s_terms[WPB][GMAX];  // (err, cerr) of each symbol
  __shared__ float o_sr[2][GMAX][WPB], o_si[2][GMAX][WPB], o_dist[2][GMAX][WPB];
  __shared__ int o_dib[2][GMAX][WPB], o_val[2][GMAX][WPB];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = blockIdx.x * WPB, c = c0 + w;
  const bool live = c < C;
  constexpr int G = 32 * H;
  constexpr bool two_level = G % 64 == 0;  // rot_ramp's two-level form
  const float PI_F = 3.14159265358979323846f;
  const float TWO_PI_F = 6.28318530717958647692f;
  if (threadIdx.x == 0) {
    // dph2 over n valid symbols, summed in symbol order
    float a = 0.0f;
    s_dph2[0] = 0.0f;
    for (int n = 1; n <= G; ++n) {
      a += pi4;
      s_dph2[n] = a;
    }
  }
  __syncthreads();

  float pos = 0.f, omega = 1.f, cphase = 0.f, cfreq = 0.f, ph2 = 0.f;
  int prev_sym = 0;
  if (live) {
    pos = st0[0 * C + c];
    omega = st0[1 * C + c];
    cphase = st0[2 * C + c];
    cfreq = st0[3 * C + c];
    ph2 = st0[4 * C + c];
    prev_sym = (int)st0[5 * C + c];
  }
  if (lane == 0) {
    int lo = 1 << 30, hi = -(1 << 30);  // a missing channel bounds nothing
    if (live) group_rows(pos, omega, G, T, lo, hi);
    s_lo[0][w] = lo;
    s_hi[0][w] = hi;
    s_lo[1][w] = 1 << 30;
    s_hi[1][w] = -(1 << 30);
  }
  __syncthreads();

  // a group's outputs, stored as rows of the block's channels
  auto store_group = [&](int g) {
    const int ob = g & 1;
    for (int i = threadIdx.x; i < G * WPB; i += blockDim.x) {
      const int k = i / WPB, ww = i % WPB;
      if (c0 + ww >= C) continue;
      const size_t o = (size_t)(g * G + k) * C + c0 + ww;
      if (sym_r != nullptr) {
        sym_r[o] = o_sr[ob][k][ww];
        sym_i[o] = o_si[ob][k][ww];
      }
      dib[o] = o_dib[ob][k][ww];
      val[o] = o_val[ob][k][ww];
      dist[o] = o_dist[ob][k][ww];
    }
  };

  for (int g = 0; g < n_groups; ++g) {
    const int ob = g & 1;
    // the block's window for this group, staged when it fits
    int r0 = 1 << 30, r1 = 0;
#pragma unroll
    for (int ww = 0; ww < WPB; ++ww) {
      r0 = min(r0, s_lo[ob][ww]);
      r1 = max(r1, s_hi[ob][ww]);
    }
    const bool staged = r1 - r0 <= WMAX;
    if (staged) {
      // asynchronous copies, in flight while the previous group's outputs
      // are stored and this group's Costas constants computed (columns past
      // C are never read)
      for (int i = threadIdx.x; i < (r1 - r0) * WPB; i += blockDim.x) {
        const int row = i / WPB, ww = i % WPB;
        if (c0 + ww < C) {
          cp_async4(&win_r[row][ww], stream_row(tail_r, mfr, r0 + row, C) + c0 + ww);
          cp_async4(&win_i[row][ww], stream_row(tail_i, mfi, r0 + row, C) + c0 + ww);
        }
      }
      cp_async_commit();
      // the next group's rows follow on: bring them towards L2
      for (int i = threadIdx.x; i < r1 - r0; i += blockDim.x) {
        const int e = r1 + i;
        if (e < T + NTAPS - 1) {
          prefetch_l2(stream_row(tail_r, mfr, e, C) + c0);
          prefetch_l2(stream_row(tail_i, mfi, e, C) + c0);
        }
      }
    }
    if (g > 0) store_group(g - 1);
    // Costas rotator of the group (rot_ramp at K = G): the start phasor and
    // the twiddle of every doubling level, once per group
    const float r_ph = ph2 - pi4 - cphase;
    const float r_fr = -pi4 - cfreq;
    float cP, sP;  // sincosf: the bits of cosf and sinf, one range reduction
    sincosf(r_ph, &sP, &cP);
    float Wc[5], Ws[5], mc[3], ms[3];
    const float fmaj = two_level ? r_fr * 8.0f : r_fr;
    sincosf(fmaj, &Ws[0], &Wc[0]);
#pragma unroll
    for (int b = 1; b < 5; ++b) {
      Wc[b] = Wc[b - 1] * Wc[b - 1] - Ws[b - 1] * Ws[b - 1];
      Ws[b] = 2.0f * Wc[b - 1] * Ws[b - 1];
    }
    sincosf(r_fr, &ms[0], &mc[0]);
#pragma unroll
    for (int b = 1; b < 3; ++b) {
      mc[b] = mc[b - 1] * mc[b - 1] - ms[b - 1] * ms[b - 1];
      ms[b] = 2.0f * mc[b - 1] * ms[b - 1];
    }
    if (staged) cp_async_wait0();
    __syncthreads();
    if (live) {

      float err_k[H], cerr_k[H], sr_[H], si_[H], dist_[H];
      int quad[H], nv = 0;
      bool valid_[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int k = lane + 32 * h;
        float p = pos + omega * (float)k;
        float fl = floorf(p);
        float mu = p - fl;
        int ipos = (int)fl;
        bool valid = ipos < T;
        int safe = min(max(ipos, 0), T - 1);
        float x_r[NTAPS], x_i[NTAPS];  // rows safe + t of the [tail | mf] stream
        if (staged) {
#pragma unroll
          for (int t = 0; t < NTAPS; ++t) {
            x_r[t] = win_r[safe - r0 + t][w];
            x_i[t] = win_i[safe - r0 + t][w];
          }
        } else {
#pragma unroll
          for (int t = 0; t < NTAPS; ++t) {
            x_r[t] = __ldg(stream_row(tail_r, mfr, safe + t, C) + c);
            x_i[t] = __ldg(stream_row(tail_i, mfi, safe + t, C) + c);
          }
        }
        float f0r = 0.f, f0i = 0.f, d_r = 0.f, d_i = 0.f;
#pragma unroll
        for (int t = 0; t < NTAPS; ++t) {
          float cb = poly.b[0][t], cd = poly.d[0][t];
#pragma unroll
          for (int j = 1; j < NPOLY; ++j) {
            cb = cb * mu + poly.b[j][t];
            cd = cd * mu + poly.d[j][t];
          }
          f0r = f0r + cb * x_r[t];
          f0i = f0i + cb * x_i[t];
          d_r = d_r + cd * x_r[t];
          d_i = d_i + cd * x_i[t];
        }
        float err = fminf(fmaxf(sgnf(f0r) * d_r + sgnf(f0i) * d_i, -4.0f), 4.0f);
        // Costas derotation: rot_ramp's doubling products at symbol k
        float ca = cP, sa = sP;
        if (two_level) {
          float cm = 1.0f, sm = 0.0f;
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (((k >> 3) >> b) & 1) rot_by(ca, sa, Wc[b], Ws[b]);
            if (((k & 7) >> b) & 1) rot_by(cm, sm, mc[b], ms[b]);
          }
          float cM = ca, sM = sa;
          ca = cM * cm - sM * sm;
          sa = sM * cm + cM * sm;
        } else {
#pragma unroll
          for (int b = 0; b < 5; ++b)
            if ((k >> b) & 1) rot_by(ca, sa, Wc[b], Ws[b]);
        }
        float sr = f0r * ca - f0i * sa;
        float si = f0i * ca + f0r * sa;
        float cerr = fminf(fmaxf(sgnf(sr) * si - sgnf(si) * sr, -1.0f), 1.0f);
        err_k[h] = err;
        cerr_k[h] = cerr;
        nv += __popc(__ballot_sync(0xffffffffu, valid));
        int a = si < 0.0f, b = sr < 0.0f;
        quad[h] = (a << 1) | (a ^ b);
        float ideal_r = b ? -0.7071f : 0.7071f;
        float ideal_i = a ? -0.7071f : 0.7071f;
        float amp = rsqrtf(sr * sr + si * si + 1e-12f);
        sr_[h] = sr;
        si_[h] = si;
        dist_[h] = fabsf(ideal_r * si - ideal_i * sr) * amp;
        valid_[h] = valid;
      }
      // valid is a prefix of the group: omega >= omega_min > 0 and rounding
      // is monotone, so p and ipos never decrease with k.  The valid terms
      // are therefore those at k < nv, summed in k order from shared memory
      // (the loads run ahead of the two chains of adds), and the last valid
      // quad is at nv - 1.
#pragma unroll
      for (int h = 0; h < H; ++h)
        s_terms[w][lane + 32 * h] = make_float2(err_k[h], cerr_k[h]);
      __syncwarp();
      float err_sum = 0.0f, cerr_sum = 0.0f;
#pragma unroll 8
      for (int k = 0; k < nv; ++k) {
        const float2 v = s_terms[w][k];
        err_sum += v.x;
        cerr_sum += v.y;
      }

      // differential extraction: the previous symbol's quad from lane - 1
      // (prev_sym before k = 0; lane 31's first-half quad before k = 32)
      int carry = prev_sym;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        int up = __shfl_up_sync(0xffffffffu, quad[h], 1);
        int prev = lane == 0 ? carry : up;
        carry = __shfl_sync(0xffffffffu, quad[h], 31);
        int diff = (quad[h] - prev) & 3;
        int dibit = diff == 2 ? 3 : (diff == 3 ? 2 : diff);
        const int k = lane + 32 * h;
        o_sr[ob][k][w] = sr_[h];
        o_si[ob][k][w] = si_[h];
        o_dist[ob][k][w] = dist_[h];
        o_dib[ob][k][w] = dibit;
        o_val[ob][k][w] = valid_[h] ? 1 : 0;
      }
      if (nv > 0) {
        const int kl = nv - 1;
        int q = __shfl_sync(0xffffffffu, quad[0], kl & 31);
        if (H > 1) {
          int q1 = __shfl_sync(0xffffffffu, quad[H - 1], kl & 31);
          if (kl >> 5) q = q1;
        }
        prev_sym = q;
      }
      const float n_valid = (float)nv;

      // one timing update per group
      float omega_n = fminf(fmaxf(omega + om_g * err_sum, omega_min), omega_max);
      pos = pos + omega * n_valid + mu_g * err_sum;
      omega = omega_n;
      // rail-gated leaky Costas frequency, phase wraps
      float leak = fabsf(cfreq) > leak_th ? 0.05f : 0.0f;
      cfreq = fminf(fmaxf((1.0f - leak) * cfreq + cb_g * cerr_sum, -clim), clim);
      float cpn = cphase + cfreq * n_valid + ca_g * cerr_sum;
      cphase = cpn - TWO_PI_F * floorf((cpn + PI_F) / TWO_PI_F);
      float r = fmodf(ph2 - s_dph2[nv], TWO_PI_F);
      if (r != 0.0f && r < 0.0f) r += TWO_PI_F;
      ph2 = r;
      if (lane == 0) group_rows(pos, omega, G, T, s_lo[ob ^ 1][w], s_hi[ob ^ 1][w]);
    }
    // outputs (double-buffered, as are the window bounds) and the next
    // window's bounds are ready
    __syncthreads();
  }
  store_group(n_groups - 1);
  if (live && lane == 0) {
    st_out[0 * C + c] = pos - (float)T;
    st_out[1 * C + c] = omega;
    st_out[2 * C + c] = cphase;
    st_out[3 * C + c] = cfreq;
    st_out[4 * C + c] = ph2;
    st_out[5 * C + c] = (float)prev_sym;
    st_out[6 * C + c] = st0[6 * C + c];
    st_out[7 * C + c] = st0[7 * C + c];
  }
}

extern "C" int launch_mm_costas(
    const void *mfr, const void *mfi, const void *tail_r, const void *tail_i,
    const void *st0, const float *polys_host, void *sym_r, void *sym_i,
    void *dib, void *val, void *dist, void *st_out, int T, int C,
    int n_groups, int G, float mu_g, float om_g, float omega_min,
    float omega_max, float ca_g, float cb_g, float clim, float leak_th,
    float pi4, void *stream) {
  // polys_host: (2, 6, 8) float32 [bank, derivative] in host memory, passed
  // to the kernel by value
  if (C <= 0 || T <= 0 || n_groups <= 0 || (G != 32 && G != 64))
    return (int)cudaErrorInvalidValue;
  K2Polys poly;
  for (int j = 0; j < NPOLY; ++j)
    for (int t = 0; t < NTAPS; ++t) {
      poly.b[j][t] = polys_host[j * NTAPS + t];
      poly.d[j][t] = polys_host[NPOLY * NTAPS + j * NTAPS + t];
    }
  auto kernel = G == 64 ? mm_costas_kernel<2> : mm_costas_kernel<1>;
  kernel<<<(C + WPB - 1) / WPB, 32 * WPB, 0, (cudaStream_t)stream>>>(
      (const float *)mfr, (const float *)mfi, (const float *)tail_r,
      (const float *)tail_i, (const float *)st0, poly, (float *)sym_r,
      (float *)sym_i, (int *)dib, (int *)val, (float *)dist, (float *)st_out,
      T, C, n_groups, mu_g, om_g, omega_min, omega_max, ca_g, cb_g, clim,
      leak_th, pi4);
  return (int)cudaGetLastError();
}
