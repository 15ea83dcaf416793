// The voice monitor's speech trellis: every row of a superblock's batched
// speech decode (voice/speech_batch.py) through the 16-state rate-1/3
// mother code of EN 300 395-2, one thread a row.
//
// Replaces no TPU kernel: the JAX package decodes speech one slot a call
// with XLA's scan (tetra_tpu/voice/channel.py).  The port's first batched
// version was that scan as torch ops, one add-compare-select step of all
// rows per handful of launches: ~1,800 launches a superblock, ~40 ms of
// host enqueue at 256 carriers.  Semantics are the plain version's
// (ops/speech_kernel.trellis_plain), operation for operation: branch
// metrics x0 e0 + x1 e1 + x2 e2 left to right (exact for the callers' soft
// values, and -fmad=false keeps the order), candidates from predecessors
// ns >> 1 and 8 + (ns >> 1), the larger taken only when strictly larger,
// metrics less their maximum each step; the end state is the first best
// (truncated rows) or 0; the traceback follows each step's 16 decision
// bits.
//
// What bounds it on the card.  At 256 carriers a superblock has ~25,000
// rows of 112 steps: ~0.3 GFLOP and ~40 MB (the soft input read once,
// the bits written once), ~12 us of either.  The rows are independent and
// their steps serial, so one thread a row, its 16 metrics in registers and
// its 112 16-bit decision words in local memory (224 bytes); 128 threads a
// block.  A thread reads its own row's 3 floats a step, so a warp touches
// 32 rows' sectors a step; at these sizes the latency of the serial steps,
// not the bytes, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 16;
constexpr int TMAX = 112;

// the ACS sign tables by value: e0[n][ns] = the sign of mother bit n on
// the transition into ns from ns >> 1, e1 from 8 + (ns >> 1)
struct TchSigns {
  float e0[3][NS];
  float e1[3][NS];
};

__global__ void speech_trellis_kernel(const float *__restrict__ x,
                                      const uint8_t *__restrict__ truncate,
                                      TchSigns s, uint8_t *__restrict__ bits,
                                      int R, int T) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float *xr = x + (size_t)r * T * 3;
  float m[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) m[i] = -1e9f;
  m[0] = 0.0f;
  uint16_t dec[TMAX];
  for (int t = 0; t < T; ++t) {
    float x0 = xr[3 * t], x1 = xr[3 * t + 1], x2 = xr[3 * t + 2];
    float nm[NS];
    uint32_t d = 0;
    float mx = -3.4e38f;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
      float b0 = x0 * s.e0[0][ns] + x1 * s.e0[1][ns] + x2 * s.e0[2][ns];
      float b1 = x0 * s.e1[0][ns] + x1 * s.e1[1][ns] + x2 * s.e1[2][ns];
      float c0 = m[ns >> 1] + b0;
      float c1 = m[8 + (ns >> 1)] + b1;
      bool take1 = c1 > c0;
      nm[ns] = take1 ? c1 : c0;
      d |= (uint32_t)take1 << ns;
      mx = fmaxf(mx, nm[ns]);
    }
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) m[ns] = nm[ns] - mx;
    dec[t] = (uint16_t)d;
  }
  int st = 0;
  if (truncate[r]) {
    float best = m[0];
#pragma unroll
    for (int ns = 1; ns < NS; ++ns)
      if (m[ns] > best) {
        best = m[ns];
        st = ns;
      }
  }
  uint8_t *out = bits + (size_t)r * T;
  for (int t = T - 1; t >= 0; --t) {
    out[t] = (uint8_t)(st & 1);
    int took1 = (dec[t] >> st) & 1;
    st = took1 ? (st >> 1) + 8 : st >> 1;
  }
}

}  // namespace

// x: (R, T, 3) float32 soft mother symbols; truncate: (R,) uint8; signs:
// (2, 3, 16) float32 in host memory (e0 then e1); bits: (R, T) uint8.
extern "C" int launch_speech_trellis(const void *x, const void *truncate,
                                     const float *signs_host, void *bits,
                                     int R, int T, void *stream) {
  if (R < 0 || T <= 0 || T > TMAX) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  TchSigns s;
  for (int n = 0; n < 3; ++n)
    for (int ns = 0; ns < NS; ++ns) {
      s.e0[n][ns] = signs_host[n * NS + ns];
      s.e1[n][ns] = signs_host[3 * NS + n * NS + ns];
    }
  const int threads = 128;
  speech_trellis_kernel<<<(R + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float *)x, (const uint8_t *)truncate, s, (uint8_t *)bits, R, T);
  return (int)cudaGetLastError();
}
