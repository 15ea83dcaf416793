// The libm replicas of tetra_tpu_torch/csrc/acelp_libm.cuh beside the
// host's own cosf and expf, called as the codec calls them (std::cos and
// std::exp of a float), for tests/test_torch_acelp_libm.py.  Plain C ABI.

#include <cmath>
#include <cstdint>

#include "../tetra_tpu_torch/csrc/acelp_libm.cuh"

extern "C" void libm_pairs(int fn, const float* x, int64_t n, float* replica,
                           float* host) {
  for (int64_t i = 0; i < n; i++) {
    if (fn == 0) {
      replica[i] = acelp_libm::glibc_cosf(x[i]);
      host[i] = std::cos(x[i]);
    } else {
      replica[i] = acelp_libm::glibc_expf(x[i]);
      host[i] = std::exp(x[i]);
    }
  }
}
