// The 16-state K=5 mother-code trellis of rx/viterbi.viterbi_decode: every
// row of a call (a chunk of the fleet's typed FEC, rx/fec.py, or any other
// caller's batch) through its forward pass and traceback in one launch,
// one thread a row.  Templated over the mother bits a step: 4 for the
// control channels' rate-1/4 code (SB1/SB2/NDB/SCH-F), 3 for the speech
// code.
//
// Replaces no TPU kernel: the JAX package's trellis (tetra_tpu/rx/
// viterbi.py) is an XLA scan.  The port's first version was that scan as
// torch ops, ~23 launches a trellis step, 144 or 288 steps a chunk: the
// whole of the typed FEC's ~45-85 ms of host enqueue a superblock.
// Semantics are the plain twin's (rx/viterbi._viterbi), operation for
// operation: branch metrics x0 e0 + x1 e1 + x2 e2 (+ x3 e3) left to right
// (-fmad=false keeps the order; the callers' soft values are {-1, 0, +1}
// and the mixed decode's pad amplitude 1000, so every metric is an exact
// integer in float32 and equals the twin's soft @ E0t), candidates from
// predecessors ns >> 1 and 8 + (ns >> 1), the second taken only when
// strictly larger, metrics less their maximum each step; the traceback
// starts on the first best state (truncated) or on state 0.
//
// What bounds it on the card.  At band256.full a superblock's short chunk
// is ~37,000 rows x 144 steps: its soft input (16 bytes a step) ~85 MB
// read once, ~25 us at 3.35 TB/s, and ~0.5-1.6 GFLOP (by what the
// algorithm needs or what this kernel computes), ~8-24 us at 67 TFLOP/s;
// band1024.host's ~148,000 rows are 4x that.  The rows are independent
// and their steps serial, so one thread a row, its 16 metrics in
// registers and its step's 16 decision bits as a 16-bit word in local
// memory (576 bytes at 288 steps); 128 threads a block.  A 4-bit step is
// one 16-byte vector load where the input is 16-byte aligned (a 3-bit
// step's 12 bytes are not; three scalar loads).  A warp touches 32 rows'
// sectors a step, reused over the next steps from L1; at these sizes the
// latency of the serial steps, not the bytes, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 16;
constexpr int TMAX = 288;

// the ACS sign tables by value: e0[n][ns] = the sign of mother bit n on
// the transition into ns from ns >> 1, e1 from 8 + (ns >> 1)
template <int NB>
struct Signs {
  float e0[NB][NS];
  float e1[NB][NS];
};

template <int NB, bool VEC>
__global__ void fec_trellis_kernel(const float *__restrict__ x, Signs<NB> s,
                                   uint8_t *__restrict__ bits, int R, int T,
                                   int truncate) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float *xr = x + (size_t)r * T * NB;
  float m[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) m[i] = -1e9f;
  m[0] = 0.0f;
  uint16_t dec[TMAX];
  for (int t = 0; t < T; ++t) {
    float xs[NB];
    if constexpr (VEC) {
      float4 v = reinterpret_cast<const float4 *>(xr)[t];
      xs[0] = v.x;
      xs[1] = v.y;
      xs[2] = v.z;
      xs[3] = v.w;
    } else {
#pragma unroll
      for (int n = 0; n < NB; ++n) xs[n] = xr[NB * t + n];
    }
    float nm[NS];
    uint32_t d = 0;
    float mx = -3.4e38f;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
      float b0 = xs[0] * s.e0[0][ns];
      float b1 = xs[0] * s.e1[0][ns];
#pragma unroll
      for (int n = 1; n < NB; ++n) {
        b0 = b0 + xs[n] * s.e0[n][ns];
        b1 = b1 + xs[n] * s.e1[n][ns];
      }
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
  if (truncate) {
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

template <int NB, bool VEC>
int launch(const float *x, const float *signs_host, uint8_t *bits, int R,
           int T, int truncate, cudaStream_t stream) {
  Signs<NB> s;
  for (int n = 0; n < NB; ++n)
    for (int ns = 0; ns < NS; ++ns) {
      s.e0[n][ns] = signs_host[n * NS + ns];
      s.e1[n][ns] = signs_host[NB * NS + n * NS + ns];
    }
  const int threads = 128;
  fec_trellis_kernel<NB, VEC><<<(R + threads - 1) / threads, threads, 0,
                                stream>>>(x, s, bits, R, T, truncate);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (R, T, nb) float32 soft mother symbols, nb 4 or 3; signs: (2, nb, 16)
// float32 in host memory (e0 then e1); bits: (R, T) uint8; truncate: end
// on the first best state, else on state 0.
extern "C" int launch_fec_trellis(const void *x, const float *signs_host,
                                  void *bits, int R, int T, int nb,
                                  int truncate, void *stream) {
  if (R < 0 || T <= 0 || T > TMAX || (nb != 3 && nb != 4))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const float *xf = (const float *)x;
  uint8_t *out = (uint8_t *)bits;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb == 3)
    return launch<3, false>(xf, signs_host, out, R, T, truncate, st);
  if (((uintptr_t)x & 15) == 0)
    return launch<4, true>(xf, signs_host, out, R, T, truncate, st);
  return launch<4, false>(xf, signs_host, out, R, T, truncate, st);
}
