// K1: chunked AGC + band-edge FLL + RRC matched filter (stage 1 of the demod).
//
// Replaces the TPU kernel tetra_tpu/ops/demod_pallas.py:agc_fll_rrc, which
// ran the five filters as banded MXU matmuls with channels on lanes and the
// 64-sample groups on a sequential grid axis.  Semantics are the plain
// version's (tetra_tpu_torch/ops/demod_kernel.agc_fll_rrc_plain):
//
//   per 64-sample group g, per channel c, with (gain, phase, freq) frozen:
//     y      = x * gain
//     rot[n] = y[n] * exp(-j(phase + freq n))   (two-level rotator recurrence,
//                                                the same ops as rot_ramp)
//     ext    = [64-row rotated history | rot]
//     mf[k]  = sum_i rrc[64-i] ext[k+i]           (65-tap RRC, k = 0..63)
//     err    = sum over the parity-balanced decimated taps k of
//              fastamp(hi(k)) - fastamp(lo(k))    (complex band-edge pair)
//     gain  *= clip(setpoint / mean|y|, 1/4, 4)^r_eff  (squelched, capped)
//     freq   = clip(freq + beta_d * err, +-lim);  phase += freq_old * 64, wrapped
//
// What bounds it on the card.  The work is ~0.94 GFLOP at the main path's
// shape (C = 256, T = 4608), ~14 us at the FP32 peak; the bytes (x in, mf
// out, 18.9 MB) take ~5.6 us.  But the 72 groups of a channel run in series,
// so the kernel is bound by the latency of one group times 72 unless the
// channels fill the card.  Design:
//   * one warp per channel, WPB = 2 channels per block: C = 256 gives 128
//     blocks on the 132 SMs.  A channel's whole group lives in one warp, so
//     the loop needs no block barrier at all, only __syncwarp;
//   * lane l rotates samples l and l+32, and in one pass over the 65 taps
//     makes mf outputs 2l and 2l+1 (each the whole 65-tap sum in the plain
//     order, so mf keeps its rounding; the window slides by one sample
//     from the first to the second) and the 8 sums of band-edge tap j = l
//     (each in order): 12 independent FMA chains per shared-memory load
//     pair, which a lone warp needs to hide the load latency;
//   * amp and err are summed by warp shuffles in the order of the first
//     port of this kernel (8 partial sums of strided terms, then those 8 in
//     order), so the kernel is bit-identical to it: the FLL phase freely
//     integrates any last-bit difference in freq, and the card check's
//     warm-up trajectory stays the one its limits were set on.  Every lane
//     forms the same sums and runs the same loop update, so the loop state
//     needs no broadcast;
//   * the rotator's six cos/sin (phase, 8 freq, freq) and their squared
//     twiddles per doubling level are computed once per group; each sample
//     runs the same doubling products from them as rot_ramp (bitwise the
//     same values);
//   * the filter taps are kernel parameters (constant bank), read as FMA
//     operands;
//   * the rotated samples sit in a ring [history | group] stored twice, so
//     a group's 128-sample window is contiguous without a history copy;
//   * group g+1's raw x is copied to shared memory with cp.async while
//     group g filters (x does not depend on the loop state).
// No tensor cores: mf is held to 2e-4 on a unit-power signal and TF32 keeps
// ~3 digits (a 3xTF32 split is later work).
#include <cuda_runtime.h>
#include <math.h>

#define KG 64
#define NTAP 65
#define WPB 2        // channels (one warp each) per block
#define RING 128     // [history | group] ring, stored twice
#define MAXKD 64

struct K1Taps {
  float lo_r[NTAP], lo_i[NTAP], hi_r[NTAP], hi_i[NTAP], rrc[NTAP];
  int offs[MAXKD];
};

__device__ __forceinline__ float fastamp(float a, float b) {
  float aa = fabsf(a), ab = fabsf(b);
  return fmaxf(aa, ab) + 0.4f * fminf(aa, ab);
}

__device__ __forceinline__ void cp_async4(float *smem, const float *gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The first port's summation orders: 8 partial sums, each over its own
// terms in order, then the 8 partials in order.  Lane y (mod 8) forms
// partial y from shuffled terms, then every lane adds the 8 partials, so
// all lanes hold the same sum.  lo / hi hold terms lane and lane + 32.
#define FULL 0xffffffffu

__device__ __forceinline__ float sum_partials(float part) {
  float total = 0.0f;
#pragma unroll
  for (int y = 0; y < 8; ++y) total += __shfl_sync(FULL, part, y);
  return total;
}

__device__ __forceinline__ float sum_runs(float lo, float hi) {
  // partial y: samples 8y .. 8y + 7
  const int y = threadIdx.x & 7;
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = 8 * y + i;
    float a = __shfl_sync(FULL, lo, n & 31), b = __shfl_sync(FULL, hi, n & 31);
    part += n < 32 ? a : b;
  }
  return sum_partials(part);
}

__device__ __forceinline__ float sum_strided(float lo, float hi, int n) {
  // partial y: taps y, y + 8, ... < n
  const int y = threadIdx.x & 7;
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = y + 8 * i;
    float t = __shfl_sync(FULL, i < 4 ? lo : hi, j & 31);
    if (j < n) part += t;
  }
  return sum_partials(part);
}

__device__ __forceinline__ void rot_by(float &c, float &s, float wc, float ws) {
  float cn = c * wc - s * ws;
  float sn = s * wc + c * ws;
  c = cn;
  s = sn;
}

struct BandEdge {
  // the complex band-edge pair at one decimated tap: 8 real sums over the
  // 65 taps, each in tap order (lo: er*lo_r, er*lo_i, ei*lo_r, ei*lo_i;
  // hi: the same)
  float rlr = 0.f, rli = 0.f, ilr = 0.f, ili = 0.f;
  float rhr = 0.f, rhi = 0.f, ihr = 0.f, ihi = 0.f;
  __device__ __forceinline__ void tap(const K1Taps &tp, int t, float a,
                                      float b) {
    const int m = NTAP - 1 - t;
    rlr = fmaf(a, tp.lo_r[m], rlr);
    rli = fmaf(a, tp.lo_i[m], rli);
    ilr = fmaf(b, tp.lo_r[m], ilr);
    ili = fmaf(b, tp.lo_i[m], ili);
    rhr = fmaf(a, tp.hi_r[m], rhr);
    rhi = fmaf(a, tp.hi_i[m], rhi);
    ihr = fmaf(b, tp.hi_r[m], ihr);
    ihi = fmaf(b, tp.hi_i[m], ihi);
  }
  __device__ __forceinline__ float err() const {
    float lo_re = rlr - ili, lo_im = rli + ilr;
    float hi_re = rhr - ihi, hi_im = rhi + ihr;
    return fastamp(hi_re, hi_im) - fastamp(lo_re, lo_im);
  }
};

__global__ void __launch_bounds__(32 * WPB)
agc_fll_rrc_kernel(const float *__restrict__ xr, const float *__restrict__ xi,
                   const float *__restrict__ gain0,
                   const float *__restrict__ phase0,
                   const float *__restrict__ freq0,
                   const float *__restrict__ hist_r0,
                   const float *__restrict__ hist_i0, const K1Taps tp, int Kd,
                   float *__restrict__ mfr, float *__restrict__ mfi,
                   float *__restrict__ gain_out, float *__restrict__ phase_out,
                   float *__restrict__ freq_out,
                   float *__restrict__ hist_r_out,
                   float *__restrict__ hist_i_out, int T, int C,
                   float r_eff, float setpoint, float squelch, float max_gain,
                   float beta_d, float freq_lim) {
  __shared__ float ring_r[WPB][2 * RING];
  __shared__ float ring_i[WPB][2 * RING];
  __shared__ float xs_r[WPB][2][KG];
  __shared__ float xs_i[WPB][2][KG];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * WPB + w;
  if (c >= C) return;  // no block barrier below: a missing warp is harmless
  float *er = ring_r[w], *ei = ring_i[w];
  const int n_groups = T / KG;

  // group 0's raw input in flight while the history loads
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int n = lane + 32 * h;
    cp_async4(&xs_r[w][0][n], xr + (size_t)n * C + c);
    cp_async4(&xs_i[w][0][n], xi + (size_t)n * C + c);
  }
  cp_async_commit();
  // history sample s = n - 64 sits at ring position s mod 128 = n + 64
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int n = lane + 32 * h;
    float vr = hist_r0[n * C + c], vi = hist_i0[n * C + c];
    er[n + 64] = vr;
    er[n + 64 + RING] = vr;
    ei[n + 64] = vi;
    ei[n + 64 + RING] = vi;
  }
  float gain = gain0[c], phase = phase0[c], freq = freq0[c];
  const float PI_F = 3.14159265358979323846f;
  const float TWO_PI_F = 6.28318530717958647692f;

  for (int g = 0; g < n_groups; ++g) {
    const int xb = g & 1;
    if (g + 1 < n_groups) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        size_t row = (size_t)((g + 1) * KG + lane + 32 * h);
        cp_async4(&xs_r[w][xb ^ 1][lane + 32 * h], xr + row * C + c);
        cp_async4(&xs_i[w][xb ^ 1][lane + 32 * h], xi + row * C + c);
      }
    }
    cp_async_commit();
    cp_async_wait1();  // group g's input has landed
    __syncwarp();      // ...for every lane; and group g-1's ring reads are done

    // rotator constants of this group (rot_ramp, K = 64, two-level)
    float cP, sP;  // sincosf: the bits of cosf and sinf, one range reduction
    sincosf(phase, &sP, &cP);
    float Mc[3], Ms[3], mc[3], ms[3];
    sincosf(freq * 8.0f, &Ms[0], &Mc[0]);
    sincosf(freq, &ms[0], &mc[0]);
#pragma unroll
    for (int b = 1; b < 3; ++b) {
      Mc[b] = Mc[b - 1] * Mc[b - 1] - Ms[b - 1] * Ms[b - 1];
      Ms[b] = 2.0f * Mc[b - 1] * Ms[b - 1];
      mc[b] = mc[b - 1] * mc[b - 1] - ms[b - 1] * ms[b - 1];
      ms[b] = 2.0f * mc[b - 1] * ms[b - 1];
    }

    // AGC apply + FLL derotation of samples lane and lane + 32
    float amp_t[2];
    const int base = (g & 1) * KG;  // ring position of this group's sample 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int n = lane + 32 * h;
      float y_r = xs_r[w][xb][n] * gain, y_i = xs_i[w][xb][n] * gain;
      amp_t[h] = sqrtf(y_r * y_r + y_i * y_i);
      float cM = cP, sM = sP, cm = 1.0f, sm = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (((n >> 3) >> b) & 1) rot_by(cM, sM, Mc[b], Ms[b]);
        if (((n & 7) >> b) & 1) rot_by(cm, sm, mc[b], ms[b]);
      }
      float cs = cM * cm - sM * sm;
      float sn = sM * cm + cM * sm;
      float rr = y_r * cs + y_i * sn;
      float ri = y_i * cs - y_r * sn;
      er[base + n] = rr;
      er[base + n + RING] = rr;
      ei[base + n] = ri;
      ei[base + n + RING] = ri;
    }
    __syncwarp();

    // the group's window [history | group] is er[w0 .. w0 + 128)
    const float *wr = er + (base ^ KG), *wi = ei + (base ^ KG);
    // One pass over the 65 taps feeds 12 independent FMA chains: the RRC
    // outputs 2 lane and 2 lane + 1 (one new window sample per tap, slid
    // from one output to the next) and the 8 band-edge sums of tap
    // j = lane.  Every sum keeps its own order.
    float err_t[2] = {0.0f, 0.0f};
    {
      const int k0 = 2 * lane;
      const int kb = lane < Kd ? tp.offs[lane] : 0;
      float x0r = wr[k0], x0i = wi[k0];
      float a0r = 0.f, a0i = 0.f, a1r = 0.f, a1i = 0.f;
      BandEdge be;
#pragma unroll
      for (int t = 0; t < NTAP; ++t) {
        const float hh = tp.rrc[NTAP - 1 - t];
        const float x1r = wr[k0 + t + 1], x1i = wi[k0 + t + 1];
        a0r = fmaf(x0r, hh, a0r);
        a0i = fmaf(x0i, hh, a0i);
        a1r = fmaf(x1r, hh, a1r);
        a1i = fmaf(x1i, hh, a1i);
        x0r = x1r;
        x0i = x1i;
        be.tap(tp, t, wr[kb + t], wi[kb + t]);
      }
      const size_t o = (size_t)(g * KG + k0) * C + c;
      mfr[o] = a0r;
      mfi[o] = a0i;
      mfr[o + C] = a1r;
      mfi[o + C] = a1i;
      if (lane < Kd) err_t[0] = be.err();
    }
    if (lane + 32 < Kd) {  // Kd > 32 (FLL_DECIM = 1): tap j = lane + 32
      const int kb = tp.offs[lane + 32];
      BandEdge be;
#pragma unroll 5
      for (int t = 0; t < NTAP; ++t) be.tap(tp, t, wr[kb + t], wi[kb + t]);
      err_t[1] = be.err();
    }
    const float amp_s = sum_runs(amp_t[0], amp_t[1]);
    const float err = sum_strided(err_t[0], err_t[1], Kd);

    // loop update, the same on every lane
    float amp_mean = fmaxf(amp_s / (float)KG, 1e-9f);
    float ratio = fminf(fmaxf(setpoint / amp_mean, 0.25f), 4.0f);
    if (amp_mean < squelch) ratio = 1.0f;
    gain = fminf(gain * powf(ratio, r_eff), max_gain);
    float np_ = phase + freq * (float)KG;
    freq = fminf(fmaxf(freq + beta_d * err, -freq_lim), freq_lim);
    phase = np_ - TWO_PI_F * floorf((np_ + PI_F) / TWO_PI_F);
  }

  if (lane == 0) {
    gain_out[c] = gain;
    phase_out[c] = phase;
    freq_out[c] = freq;
  }
  // the last group's samples are the new history
  const int last = ((n_groups - 1) & 1) * KG;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int n = lane + 32 * h;
    hist_r_out[n * C + c] = er[last + n];
    hist_i_out[n * C + c] = ei[last + n];
  }
}

extern "C" int launch_agc_fll_rrc(
    const void *xr, const void *xi, const void *gain0, const void *phase0,
    const void *freq0, const void *hist_r0, const void *hist_i0,
    const float *taps_host, const int *offs_host, int Kd, void *mfr,
    void *mfi, void *gain_out, void *phase_out, void *freq_out,
    void *hist_r_out, void *hist_i_out, int T, int C, float r_eff,
    float setpoint, float squelch, float max_gain, float beta_d,
    float freq_lim, void *stream) {
  // taps_host: (5, 65) float32 [lo_r, lo_i, hi_r, hi_i, rrc] in host memory;
  // offs_host: Kd int32 band-edge tap offsets in host memory.  Both go to
  // the kernel by value.
  if (T % KG != 0 || T <= 0 || Kd <= 0 || Kd > MAXKD || C <= 0)
    return (int)cudaErrorInvalidValue;
  K1Taps tp;
  float *dst[5] = {tp.lo_r, tp.lo_i, tp.hi_r, tp.hi_i, tp.rrc};
  for (int f = 0; f < 5; ++f)
    for (int t = 0; t < NTAP; ++t) dst[f][t] = taps_host[f * NTAP + t];
  for (int j = 0; j < MAXKD; ++j) tp.offs[j] = j < Kd ? offs_host[j] : 0;
  for (int j = 0; j < Kd; ++j)
    if (tp.offs[j] < 0 || tp.offs[j] >= KG) return (int)cudaErrorInvalidValue;
  agc_fll_rrc_kernel<<<(C + WPB - 1) / WPB, 32 * WPB, 0,
                       (cudaStream_t)stream>>>(
      (const float *)xr, (const float *)xi, (const float *)gain0,
      (const float *)phase0, (const float *)freq0, (const float *)hist_r0,
      (const float *)hist_i0, tp, Kd, (float *)mfr, (float *)mfi,
      (float *)gain_out, (float *)phase_out, (float *)freq_out,
      (float *)hist_r_out, (float *)hist_i_out, T, C, r_eff, setpoint,
      squelch, max_gain, beta_d, freq_lim);
  return (int)cudaGetLastError();
}
