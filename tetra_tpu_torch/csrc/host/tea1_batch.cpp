// TEA1 keystreams of many slots at once (EN 300 392-7; the cipher's
// structure and tables as published by the TETRA:BURST disclosure, the
// same generator as crypto/tea.py, byte for byte).  The fleet receiver's
// voice monitor makes a superblock's keystreams in one call: each slot's
// 29-bit IV and its cell's 80-bit encryption key, the slots spread over
// worker threads.  The two 16-bit word filters and the bit reorder are
// tables of every input, built once by tea1_init from the published
// constants.
//
// Plain C ABI for ctypes binding.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

uint8_t g_sbox[256];
uint8_t g_filter_a[1 << 16], g_filter_b[1 << 16], g_reorder[256];

inline uint32_t rotr8(uint32_t b) { return ((b >> 1) | (b << 7)) & 0xFF; }

void build_filter(const uint16_t* lut, uint8_t* out) {
  for (uint32_t w = 0; w < (1u << 16); w++) {
    uint32_t b0 = w & 0xFF, b1 = w >> 8, v = 0;
    for (int i = 0; i < 8; i++) {
      uint32_t dist = ((b0 >> 7) & 1) | ((b0 << 1) & 2) | ((b1 << 1) & 12);
      v |= ((lut[i] >> dist) & 1u) << i;
      b0 = rotr8(b0);
      b1 = rotr8(b1);
    }
    out[w] = (uint8_t)v;
  }
}

void keystream(uint32_t iv32, const uint8_t* key, int64_t n_bytes,
               uint8_t* out) {
  uint64_t x = (iv32 ^ 0x96724FA1u) & 0xFFFFFFFFu;
  x = ((x << 8) | (x >> 24)) & 0xFFFFFFFFu;
  uint64_t q = ((uint64_t)iv32 << 32) | x;
  uint64_t iv = (q >> 8) | (q << 56);
  uint32_t kreg = 0;
  for (int i = 0; i < 10; i++)
    kreg = (kreg << 8) | g_sbox[((kreg >> 24) ^ key[i] ^ kreg) & 0xFF];
  int rounds = 54;
  for (int64_t j = 0; j < n_bytes; j++) {
    for (int r = 0; r < rounds; r++) {
      uint32_t s = g_sbox[((kreg >> 24) ^ kreg) & 0xFF];
      kreg = (kreg << 8) | s;
      uint64_t d12 = g_filter_a[(iv >> 8) & 0xFFFF];
      uint64_t d56 = g_filter_b[(iv >> 40) & 0xFFFF];
      uint64_t r4 = g_reorder[(iv >> 32) & 0xFF];
      uint64_t nb = (d56 ^ (iv >> 56) ^ r4 ^ s) & 0xFF;
      iv = ((iv << 8) ^ (d12 << 32)) | nb;
    }
    out[j] = (uint8_t)(iv >> 56);
    rounds = 19;
  }
}

}  // namespace

extern "C" {

// The S-box (256 bytes) and the two word-filter LUTs (8 x 16 bits each).
void tea1_init(const uint8_t* sbox, const uint16_t* lut_a,
               const uint16_t* lut_b) {
  std::memcpy(g_sbox, sbox, 256);
  build_filter(lut_a, g_filter_a);
  build_filter(lut_b, g_filter_b);
  for (uint32_t b = 0; b < 256; b++)
    g_reorder[b] = (uint8_t)((((b << 6) & 0x40) | ((b << 1) & 0x20) |
                              ((b << 2) & 0x08) | ((b >> 3) & 0x14) |
                              ((b >> 2) & 0x01) | ((b >> 5) & 0x02) |
                              ((b << 4) & 0x80)) & 0xFF);
}

// n keystreams of n_bytes each into out (n x n_bytes): slot i's IV iv[i]
// under the 80-bit key keys[key_of[i]] (10 bytes each).
void tea1_batch(const uint32_t* iv, const int64_t* key_of,
                const uint8_t* keys, int64_t n, int64_t n_bytes,
                uint8_t* out, int64_t threads) {
  auto run = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; i++)
      keystream(iv[i], keys + key_of[i] * 10, n_bytes, out + i * n_bytes);
  };
  if (threads > n) threads = n;
  if (threads <= 1) {
    run(0, n);
    return;
  }
  std::vector<std::thread> ws;
  for (int64_t w = 0; w < threads; w++)
    ws.emplace_back(run, w * n / threads, (w + 1) * n / threads);
  for (auto& t : ws) t.join();
}

}  // extern "C"
