// The card's ACELP synthesis (tetra_tpu_torch/csrc/acelp_synth_core.cuh)
// built for the host: the kernel's arithmetic with one lane taking every
// lane's work in turn, its calls one after another, for
// tests/test_torch_acelp_synth.py.  The arguments are launch_acelp_synth's,
// in host memory.  Returns -1 on a size that differs from the wrapper's,
// -2 where an adaptive-codebook chunk read a sample of its own chunk (the
// warp would read it stale).  Plain C ABI.

#include <cstdint>

#include "../tetra_tpu_torch/csrc/acelp_synth_core.cuh"

extern "C" int acelp_synth_emulate(const uint8_t* frames, const uint8_t* bfi,
                                   const int8_t* kind, const int32_t* order,
                                   const int32_t* seg, const int32_t* keys,
                                   int n_calls, void* pool,
                                   const void* tables, int16_t* pcm,
                                   int state_bytes, int table_bytes) {
  using namespace acelp_synth;
  if (state_bytes != (int)sizeof(State) || table_bytes != (int)sizeof(Tables))
    return -1;
  static Work w;
  chunk_faults = 0;
  for (int c = 0; c < n_calls; c++)
    run_call(w, (State*)pool + keys[c], order, seg[c], seg[c + 1], frames,
             bfi, kind, (const Tables*)tables, pcm, 0);
  return chunk_faults ? -2 : 0;
}
