// The voice monitor's ACELP synthesis on the card: a superblock's codec
// frames of every call decoded to 8 kHz PCM in one launch, each call's
// decoder state kept on the card between launches (voice/monitor.py ->
// ops/acelp_kernel.AcelpCardBank).
//
// Replaces no TPU kernel: the JAX package synthesises speech in host C++
// (tetra_tpu/voice/acelp.py over the codec acelp_codec.cpp), as the port
// did up to here (AcelpBank: tetra_acelp_decode_batch of
// csrc/host/acelp_batch.cpp over the engine's worker threads, ~85 ms a
// superblock at 256 carriers).  The function is that batch call's, bit
// for bit: its plain twin is the host codec itself, which the port runs
// on CPU devices; acelp_synth_core.cuh holds the arithmetic, which the
// CPU tests also build with g++ and hold to the codec.
//
// What bounds it on the card.  A superblock at 256 carriers is ~12,700
// items of 768 calls: 3.5 MB of frames in and 12.2 MB of PCM out, a few
// microseconds of HBM, and ~0.1 GFLOP.  Each call is a serial chain of
// ~33 frames: its synthesis filter alone is 2,400 dependent float
// subtractions a frame, so the bound is the latency of the longest
// call's chain (~0.2 ms at 4 cycles an operation).  The design: one warp
// a call (768 warps, under one wave of the card), the call's state and
// excitation in shared memory for the whole launch; the recursions on one
// lane in the codec's order, everything elementwise or independent
// spread over the lanes (acelp_synth_core.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "acelp_synth_core.cuh"

namespace {

constexpr int WARPS = 4;       // calls a block

__global__ void __launch_bounds__(32 * WARPS)
    acelp_synth_kernel(const uint8_t *__restrict__ frames,
                       const uint8_t *__restrict__ bfi,
                       const int8_t *__restrict__ kind,
                       const int32_t *__restrict__ order,
                       const int32_t *__restrict__ seg,
                       const int32_t *__restrict__ keys, int n_calls,
                       acelp_synth::State *pool,
                       const acelp_synth::Tables *tables, int16_t *pcm) {
  __shared__ acelp_synth::Work work[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= n_calls) return;
  acelp_synth::run_call(work[warp], pool + keys[c], order, seg[c],
                        seg[c + 1], frames, bfi, kind, tables, pcm, lane);
}

}  // namespace

// Synthesise the items of n_calls calls: call c's items are
// order[seg[c] .. seg[c+1]), in time order, on decoder pool[keys[c]] (keys
// distinct); item i has frames[i] (2 x 137 bits, bit per byte), bfi[i] (2
// flags), kind[i] and writes pcm[i] (480 s16).  tables: the codec's
// runtime tables, or null for its parametric quantizers.  state_bytes and
// table_bytes are the caller's sizes of State and Tables, checked.
extern "C" int launch_acelp_synth(const void *frames, const void *bfi,
                                  const void *kind, const void *order,
                                  const void *seg, const void *keys,
                                  int n_calls, void *pool, const void *tables,
                                  void *pcm, int state_bytes, int table_bytes,
                                  void *stream) {
  if (n_calls < 0 || state_bytes != (int)sizeof(acelp_synth::State) ||
      table_bytes != (int)sizeof(acelp_synth::Tables))
    return (int)cudaErrorInvalidValue;
  if (n_calls == 0) return 0;
  acelp_synth_kernel<<<(n_calls + WARPS - 1) / WARPS, 32 * WARPS, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t *)frames, (const uint8_t *)bfi, (const int8_t *)kind,
      (const int32_t *)order, (const int32_t *)seg, (const int32_t *)keys,
      n_calls, (acelp_synth::State *)pool,
      (const acelp_synth::Tables *)tables, (int16_t *)pcm);
  return (int)cudaGetLastError();
}
