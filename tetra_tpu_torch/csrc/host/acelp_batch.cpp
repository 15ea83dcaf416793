// Batched ACELP synthesis for the fleet receiver's voice monitor: one call
// decodes a superblock's codec frames for many calls at once, each call
// (carrier, timeslot) on its own decoder, the calls spread over worker
// threads.  The codec is acelp_codec.cpp itself, included whole, so the
// per-channel AcelpDecoder and these batches share one build, one set of
// loaded codec tables and the same floats.
//
// Plain C ABI for ctypes binding.

#include <thread>
#include <vector>

#include "acelp_codec.cpp"

namespace {

// one item: a traffic slot's 480 samples from its (2, 137) frames
void decode_item(void* h, const uint8_t* frames, const uint8_t* bfi,
                 int8_t kind, int16_t* out) {
  if (kind == 0) {                       // full slot: both frames
    tetra_acelp_decode_frame(h, frames, bfi[0], out);
    tetra_acelp_decode_frame(h, frames + 137, bfi[1], out + 240);
  } else if (kind == 1) {                // first half stolen: silence, frame 2
    std::memset(out, 0, 240 * sizeof(int16_t));
    tetra_acelp_decode_frame(h, frames + 137, bfi[1], out + 240);
  } else {                               // withheld: silence, decoder idle
    std::memset(out, 0, 480 * sizeof(int16_t));
  }
}

}  // namespace

extern "C" {

// Synthesize n items.  The items of call k are order[seg[k] .. seg[k+1]),
// in time order, on decoder handles[k]; item i has frames[i] (2 x 137 bits,
// bit per byte), bfi[i] (2 flags), kind[i] (0 full slot, 1 surviving second
// half: 240 samples of silence then its frame, 2 withheld: 480 samples of
// silence) and writes out[i] (480 s16 samples).  Calls are independent and
// are spread over `threads` workers by item count; each call runs on one.
void tetra_acelp_decode_batch(void* const* handles, int64_t n_calls,
                              const int64_t* seg, const int64_t* order,
                              const uint8_t* frames, const uint8_t* bfi,
                              const int8_t* kind, int16_t* out,
                              int64_t threads) {
  auto run = [&](int64_t k0, int64_t k1) {
    for (int64_t k = k0; k < k1; k++)
      for (int64_t j = seg[k]; j < seg[k + 1]; j++) {
        int64_t i = order[j];
        decode_item(handles[k], frames + i * 274, bfi + i * 2, kind[i],
                    out + i * 480);
      }
  };
  int64_t total = seg[n_calls];
  if (threads > n_calls) threads = n_calls;
  if (threads <= 1 || total == 0) {
    run(0, n_calls);
    return;
  }
  // worker w takes the calls whose items start in its share of the items
  std::vector<int64_t> cut(threads + 1, n_calls);
  cut[0] = 0;
  for (int64_t w = 1, k = 0; w < threads; w++) {
    int64_t target = total * w / threads;
    while (k < n_calls && seg[k] < target) k++;
    cut[w] = k;
  }
  std::vector<std::thread> ws;
  for (int64_t w = 0; w < threads; w++)
    if (cut[w + 1] > cut[w]) ws.emplace_back(run, cut[w], cut[w + 1]);
  for (auto& t : ws) t.join();
}

}  // extern "C"
