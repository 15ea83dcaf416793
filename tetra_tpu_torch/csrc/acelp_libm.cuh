// The C library's cosf and expf, as the host codec (csrc/host/acelp_codec.cpp)
// calls them through std::cos(float) and std::exp(float), for the card's
// ACELP synthesis (acelp_synth.cu).  The card's own cosf/expf, and cos/exp
// in double rounded once to float, part from glibc's on some floats of the
// codec's ranges (cos in [0, 3.2], exp in [0, 9]); these are glibc's
// algorithms (2.28 on:
// sysdeps/ieee754/flt-32/s_cosf.c with sincosf.h, and e_expf.c), written
// out in double arithmetic with their tables, so they round as the host
// does on every float.  Each computes in double and rounds once to float;
// built without contraction (nvcc -fmad=false, g++ on x86-64's baseline)
// they equal glibc's results with fma or without.
//
// Usable from host and device code: tests/test_torch_acelp_libm.py builds
// this header with g++ and holds it to the host's libm bit for bit.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define ACELP_LIBM_FN __host__ __device__ inline
#else
#define ACELP_LIBM_FN inline
#endif

namespace acelp_libm {

// 2^(i/32) rounded to double, less i << 47 (glibc's __exp2f_data.tab)
#define ACELP_EXP2F_TAB                                                       \
  {0x3ff0000000000000ULL, 0x3fefd9b0d3158574ULL, 0x3fefb5586cf9890fULL,       \
   0x3fef9301d0125b51ULL, 0x3fef72b83c7d517bULL, 0x3fef54873168b9aaULL,       \
   0x3fef387a6e756238ULL, 0x3fef1e9df51fdee1ULL, 0x3fef06fe0a31b715ULL,       \
   0x3feef1a7373aa9cbULL, 0x3feedea64c123422ULL, 0x3feece086061892dULL,       \
   0x3feebfdad5362a27ULL, 0x3feeb42b569d4f82ULL, 0x3feeab07dd485429ULL,       \
   0x3feea47eb03a5585ULL, 0x3feea09e667f3bcdULL, 0x3fee9f75e8ec5f74ULL,       \
   0x3feea11473eb0187ULL, 0x3feea589994cce13ULL, 0x3feeace5422aa0dbULL,       \
   0x3feeb737b0cdc5e5ULL, 0x3feec49182a3f090ULL, 0x3feed503b23e255dULL,       \
   0x3feee89f995ad3adULL, 0x3feeff76f2fb5e47ULL, 0x3fef199bdd85529cULL,       \
   0x3fef3720dcef9069ULL, 0x3fef5818dcfba487ULL, 0x3fef7c97337b9b5fULL,       \
   0x3fefa4afa2a490daULL, 0x3fefd0765b6e4540ULL}

// 4/pi to 192 bits, 8 new bits an entry (glibc's __inv_pio4)
#define ACELP_INV_PIO4                                                        \
  {0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,    \
   0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,    \
   0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,    \
   0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041}

#ifdef __CUDACC__
__constant__ uint64_t kExp2fTabDev[32] = ACELP_EXP2F_TAB;
__constant__ uint32_t kInvPio4Dev[24] = ACELP_INV_PIO4;
#endif
static const uint64_t kExp2fTabHost[32] = ACELP_EXP2F_TAB;
static const uint32_t kInvPio4Host[24] = ACELP_INV_PIO4;

ACELP_LIBM_FN uint64_t exp2f_tab(int i) {
#ifdef __CUDA_ARCH__
  return kExp2fTabDev[i];
#else
  return kExp2fTabHost[i];
#endif
}

ACELP_LIBM_FN uint32_t inv_pio4(int i) {
#ifdef __CUDA_ARCH__
  return kInvPio4Dev[i];
#else
  return kInvPio4Host[i];
#endif
}

ACELP_LIBM_FN uint32_t f_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

ACELP_LIBM_FN float bits_f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

ACELP_LIBM_FN uint64_t d_bits(double x) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__double_as_longlong(x);
#else
  uint64_t u;
  memcpy(&u, &x, 8);
  return u;
#endif
}

ACELP_LIBM_FN double bits_d(uint64_t u) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)u);
#else
  double x;
  memcpy(&x, &u, 8);
  return x;
#endif
}

// sinf_poly of sincosf.h: the sine polynomial for even n, the cosine one
// for odd n, from table 1 (c0-c4 negated) where neg
ACELP_LIBM_FN float sinf_poly(double x, double x2, bool neg, int n) {
  if ((n & 1) == 0) {
    const double S1 = -0x1.555545995a603p-3, s2 = 0x1.1107605230bc4p-7,
                 s3 = -0x1.994eb3774cf24p-13;
    double x3 = x * x2;
    double s1 = s2 + x2 * s3;
    double x7 = x3 * x2;
    double s = x + x3 * S1;
    return (float)(s + x7 * s1);
  }
  const double g = neg ? -1.0 : 1.0;
  const double c0 = g * 0x1p0, C1 = g * -0x1.ffffffd0c621cp-2,
               C2 = g * 0x1.55553e1068f19p-5,
               c3 = g * -0x1.6c087e89a359dp-10,
               c4 = g * 0x1.99343027bf8c3p-16;
  double x4 = x2 * x2;
  double c2 = c3 + x2 * c4;
  double c1 = c0 + x2 * C1;
  double x6 = x4 * x2;
  double c = c1 + x4 * C2;
  return (float)(c + x6 * c2);
}

// reduce_large of s_cosf.c: x mod pi/2 from 4/pi's bits, for |y| >= 120
ACELP_LIBM_FN double reduce_large(uint32_t xi, int *np) {
  int a = (xi >> 26) & 15;
  int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = (uint32_t)(xi * inv_pio4(a));
  uint64_t res1 = (uint64_t)xi * inv_pio4(a + 4);
  uint64_t res2 = (uint64_t)xi * inv_pio4(a + 8);
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  double x = (double)(int64_t)res0;
  *np = (int)n;
  return x * 0x1.921fb54442d18p-62;
}

// glibc's cosf(y); sign[4] = {1, -1, -1, 1} is written as a test of bit 1
// of n + 1
ACELP_LIBM_FN float glibc_cosf(float y) {
  double x = y;
  uint32_t top = (f_bits(y) >> 20) & 0x7ff;   // abstop12
  if (top < 0x3f4) {                          // abstop12(pi/4f)
    if (top < 0x398) return 1.0f;             // abstop12(0x1p-12f)
    return sinf_poly(x, x * x, false, 1);
  }
  if (top < 0x42f) {                          // abstop12(120.0f)
    double r = x * 0x1.45f306dc9c883p+23;     // 2/pi * 2^24
    int n = ((int32_t)r + 0x800000) >> 24;
    x = x - n * 0x1.921fb54442d18p+0;
    double s = ((n + 1) & 2) ? -1.0 : 1.0;   // sign[n & 3]
    return sinf_poly(x * s, x * x, (n & 2) != 0, n ^ 1);
  }
  if (top < 0x7f8) {                          // abstop12(INFINITY)
    uint32_t xi = f_bits(y);
    int sgn = xi >> 31;
    int n;
    x = reduce_large(xi, &n);
    double s = ((n + sgn + 1) & 2) ? -1.0 : 1.0;
    return sinf_poly(x * s, x * x, ((n + sgn) & 2) != 0, n ^ 1);
  }
  return (y - y) / (y - y);                   // inf or nan
}

// glibc's expf(x)
ACELP_LIBM_FN float glibc_expf(float x) {
  const double N = 32.0;
  uint32_t abstop = (f_bits(x) >> 20) & 0x7ff;
  if (abstop >= 0x42b) {                      // top12(88.0f): |x| >= 88, nan
    if (f_bits(x) == 0xff800000u) return 0.0f;
    if (abstop >= 0x7f8) return x + x;
    if (x > 0x1.62e42ep6f) return bits_f(0x7f800000u);   // overflow: inf
    if (x < -0x1.9fe368p6f) return 0.0f;                 // underflow
  }
  double xd = x;
  double z = (0x1.71547652b82fep+0 * N) * xd;
  double kd = z + 0x1.8p52;
  uint64_t ki = d_bits(kd);
  kd -= 0x1.8p52;
  double r = z - kd;
  uint64_t t = exp2f_tab((int)(ki % 32)) + (ki << 47);
  double s = bits_d(t);
  const double C0 = 0x1.c6af84b912394p-5 / N / N / N,
               C1 = 0x1.ebfce50fac4f3p-3 / N / N,
               C2 = 0x1.62e42ff0c52d6p-1 / N;
  z = C0 * r + C1;
  double r2 = r * r;
  double y = C2 * r + 1;
  y = z * r2 + y;
  y = y * s;
  return (float)y;
}

}  // namespace acelp_libm
