// K4 (fold + DFT + hop-phase flip) and the 18/25 polyphase resample that,
// after it, makes up K3: the wideband front end.
//
// Replaces the TPU kernels tetra_tpu/ops/chan_pallas.py:fold_dft (K4) and
// :fold_dft_resample (K3).  Semantics are the plain channelizer's
// (tetra_tpu_torch/ops/chan_kernel.fold_dft_plain and
// tetra_tpu_torch/parallel/channelizer._resample_stream_block_fm):
//
//   fold:  f[m, d*hop + c] = sum_j z[m + 2j + d, c] F[2j + d, c]
//   DFT:   y[m, k] = sum_b f[m, b] exp(-2 pi i b k / n_ch)
//   flip:  y[m, k] *= (-1)^(m k)
//   resample: out[18q + p] = sum_t coef[p, t] x[25q + off[p] + t] over the
//             stream [23-row history | y]
//
// K3 is two launches: the K4 kernel, then resample_kernel reading the
// frame-major 50 kHz rows it wrote.  The TPU kernel carried a 25-row halo
// through its sequential grid instead; on the card every output row simply
// reads its 24 input rows (history rows included) from device memory.
//
// K4's function is bound by bytes on the card (z in, y out: ~20 MB at
// n_ch = 256, t50 = 6400); its least work is the fold's 48 complex taps
// per branch and a length-n_ch FFT per frame.  fold_fft_kernel (n_ch a
// power of two, 16..1024) does that work and no more:
//   - a block takes FT consecutive frames and every branch (FT = 16 up to
//     n_ch = 256, FT * n_ch = 4096 above, so the two FFT buffers take at
//     most 64 KB); a thread owns a branch and FT register accumulators,
//     and goes through its 48 taps in order (the plain version's summation
//     order) over a register window of FT z rows that moves on by two rows
//     a tap, so it reads each of the FT + 94 rows its frames need once
//     (coalesced over branch columns);
//   - the FT folded frames go to shared memory, where a Stockham
//     autosort FFT (a radix-2 stage first when log2 n_ch is odd, then
//     radix-4 stages) ping-pongs between two buffers, with twiddles from
//     the host's float32-rounded exp(-2 pi i t / n_ch) table;
//   - the flip is applied as the frames are stored, coalesced over k.
// Any other even n_ch takes fold_dft_kernel: the fold one (frame, branch)
// item per thread, then a dense n_ch x n_ch matrix DFT on the FP32 pipes
// against the host's W table.
#include <cuda_runtime.h>

#define TM 16
#define FOLD_THREADS 256
#define TPB 48            // taps per branch: channelizer.TAPS_PER_BRANCH
#define FFT_THREADS 256
#define FFT_POINTS 4096   // FT * n_ch of the FFT kernel's blocks above 256

__global__ void __launch_bounds__(FOLD_THREADS)
fold_dft_kernel(const float *__restrict__ zr, const float *__restrict__ zi,
                const float *__restrict__ F,    // (n_s, hop)
                const float *__restrict__ Wtr,  // (n_ch, n_ch): [b][k]
                const float *__restrict__ Wti, float *__restrict__ yr,
                float *__restrict__ yi, int n_out, int n_ch, int n_s) {
  extern __shared__ float sm[];
  float *fr = sm;                 // [TM][n_ch]
  float *fi = sm + TM * n_ch;     // [TM][n_ch]
  const int hop = n_ch / 2;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < TM * n_ch; idx += blockDim.x) {
    int m = idx / n_ch, b = idx - m * n_ch;
    int d = b / hop, c = b - d * hop;
    int mg = m0 + m;
    float ar = 0.0f, ai = 0.0f;
    if (mg < n_out) {
      for (int s = d; s < n_s; s += 2) {
        float w = F[s * hop + c];
        ar = ar + zr[(size_t)(mg + s) * hop + c] * w;
        ai = ai + zi[(size_t)(mg + s) * hop + c] * w;
      }
    }
    fr[idx] = ar;
    fi[idx] = ai;
  }
  __syncthreads();

  for (int k = tid; k < n_ch; k += blockDim.x) {
    float accr[TM], acci[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      accr[m] = 0.0f;
      acci[m] = 0.0f;
    }
    for (int b = 0; b < n_ch; ++b) {
      float wr = Wtr[(size_t)b * n_ch + k];
      float wi = Wti[(size_t)b * n_ch + k];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        float a = fr[m * n_ch + b], c = fi[m * n_ch + b];
        accr[m] = fmaf(a, wr, accr[m]);
        accr[m] = fmaf(-c, wi, accr[m]);
        acci[m] = fmaf(a, wi, acci[m]);
        acci[m] = fmaf(c, wr, acci[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      int mg = m0 + m;
      if (mg < n_out) {
        float flip = (mg & k & 1) ? -1.0f : 1.0f;
        yr[(size_t)mg * n_ch + k] = accr[m] * flip;
        yi[(size_t)mg * n_ch + k] = acci[m] * flip;
      }
    }
  }
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -(a.y * w.y)), fmaf(a.x, w.y, a.y * w.x));
}

template <int FT>
__global__ void __launch_bounds__(FFT_THREADS, 2)
fold_fft_kernel(const float *__restrict__ zr, const float *__restrict__ zi,
                const float *__restrict__ F,    // (2 TPB, hop)
                const float2 *__restrict__ tw,  // (n_ch,) exp(-2 pi i t/n_ch)
                float *__restrict__ yr, float *__restrict__ yi, int n_out,
                int log2n) {
  extern __shared__ float2 sm2[];
  const int n_ch = 1 << log2n, hop = n_ch >> 1;
  float2 *src = sm2;                  // [FT][n_ch]
  float2 *dst = sm2 + FT * n_ch;      // [FT][n_ch]
  float2 *tws = sm2 + 2 * FT * n_ch;  // [n_ch]
  const int m0 = blockIdx.x * FT;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int last = n_out + 2 * TPB - 2;  // z's last row
  for (int t = tid; t < n_ch; t += nt) tws[t] = tw[t];

  // Fold, tap by tap: at tap j the frames m0 + m read rows m0 + d + 2j + m,
  // a window of FT rows that moves on by two rows a tap, so each row is
  // loaded once, and each accumulator sums in tap order.  The loops are
  // unrolled: the window and the accumulators are registers.  Rows past
  // z's end are clamped: they feed only frames >= n_out, which are
  // computed and never stored.
  for (int b = tid; b < n_ch; b += nt) {
    const int d = b >= hop, c = b - d * hop;
    float ar[FT], ai[FT], vr[FT + 2 * TPB - 2], vi[FT + 2 * TPB - 2];
#pragma unroll
    for (int m = 0; m < FT; ++m) ar[m] = ai[m] = 0.0f;
#pragma unroll
    for (int j = 0; j < TPB; ++j) {
      const float w = __ldg(&F[(2 * j + d) * hop + c]);
#pragma unroll
      for (int i = j ? 2 * j + FT - 2 : 0; i < 2 * j + FT; ++i) {
        const size_t row = min(m0 + d + i, last);
        vr[i] = __ldg(&zr[row * hop + c]);
        vi[i] = __ldg(&zi[row * hop + c]);
      }
#pragma unroll
      for (int m = 0; m < FT; ++m) {
        ar[m] = ar[m] + vr[2 * j + m] * w;
        ai[m] = ai[m] + vi[2 * j + m] * w;
      }
    }
#pragma unroll
    for (int m = 0; m < FT; ++m) src[m * n_ch + b] = make_float2(ar[m], ai[m]);
  }
  __syncthreads();

  // Stockham FFT over each frame: a stage of radix R after stages whose
  // radices multiply to p maps x[i + r N/R] (i < N/R, k = i mod p), times
  // exp(-2 pi i r k / (p R)), through a length-R DFT to
  // y[(i - k) R + k + r p].
  int p = 1;
  if (log2n & 1) {  // radix 2 at p = 1: no twiddles
    for (int t = tid; t < FT * hop; t += nt) {
      const int m = t >> (log2n - 1), i = t & (hop - 1);
      const float2 *x = src + m * n_ch;
      float2 *y = dst + m * n_ch;
      const float2 a = x[i], e = x[i + hop];
      y[2 * i] = cadd(a, e);
      y[2 * i + 1] = csub(a, e);
    }
    float2 *s = src; src = dst; dst = s;
    p = 2;
    __syncthreads();
  }
  const int lq = log2n - 2, q = 1 << lq;
  for (; p < n_ch; p <<= 2) {
    const int stride = n_ch / (4 * p);
    for (int t = tid; t < FT * q; t += nt) {
      const int m = t >> lq, i = t & (q - 1), k = i & (p - 1);
      const float2 *x = src + m * n_ch;
      float2 *y = dst + m * n_ch;
      const float2 u0 = x[i];
      const float2 u1 = cmul(x[i + q], tws[k * stride]);
      const float2 u2 = cmul(x[i + 2 * q], tws[2 * k * stride]);
      const float2 u3 = cmul(x[i + 3 * q], tws[3 * k * stride]);
      const float2 s02 = cadd(u0, u2), d02 = csub(u0, u2);
      const float2 s13 = cadd(u1, u3), d13 = csub(u1, u3);
      const float2 jd13 = make_float2(d13.y, -d13.x);  // -i d13
      const int j = ((i - k) << 2) + k;
      y[j] = cadd(s02, s13);
      y[j + p] = cadd(d02, jd13);
      y[j + 2 * p] = csub(s02, s13);
      y[j + 3 * p] = csub(d02, jd13);
    }
    float2 *s = src; src = dst; dst = s;
    __syncthreads();
  }

  // Flip and store: the block's frames are contiguous rows of y.
  const int n_here = min(FT, n_out - m0) * n_ch;
  for (int t = tid; t < n_here; t += nt) {
    const int mg = m0 + (t >> log2n), k = t & (n_ch - 1);
    const float flip = (mg & k & 1) ? -1.0f : 1.0f;
    const float2 v = src[t];
    yr[(size_t)m0 * n_ch + t] = v.x * flip;
    yi[(size_t)m0 * n_ch + t] = v.y * flip;
  }
}

__global__ void resample_kernel(const float *__restrict__ xr,
                                const float *__restrict__ xi,  // (t_in, C)
                                const float *__restrict__ hr,
                                const float *__restrict__ hi,  // (pad, C)
                                const float *__restrict__ coef,  // (L, ntap)
                                const int *__restrict__ off,     // (L,)
                                float *__restrict__ yr, float *__restrict__ yi,
                                int t_out, int C, int L, int M, int ntap,
                                int pad) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (c >= C || n >= t_out) return;
  const int q = n / L, p = n - q * L;
  const int base = q * M + off[p];  // row of the [history | x] stream
  float ar = 0.0f, ai = 0.0f;
  for (int t = 0; t < ntap; ++t) {
    int e = base + t;
    float vr, vi;
    if (e < pad) {
      vr = hr[(size_t)e * C + c];
      vi = hi[(size_t)e * C + c];
    } else {
      vr = xr[(size_t)(e - pad) * C + c];
      vi = xi[(size_t)(e - pad) * C + c];
    }
    float w = coef[p * ntap + t];
    ar = fmaf(w, vr, ar);
    ai = fmaf(w, vi, ai);
  }
  yr[(size_t)n * C + c] = ar;
  yi[(size_t)n * C + c] = ai;
}

template <int FT>
static int launch_fold_fft(const void *zr, const void *zi, const void *F,
                           const void *tw, void *yr, void *yi, int n_out,
                           int n_ch, int log2n, cudaStream_t stream) {
  size_t smem = (2 * (size_t)FT + 1) * n_ch * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fold_fft_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_out + FT - 1) / FT);
  int threads = n_ch < FFT_THREADS ? n_ch : FFT_THREADS;
  fold_fft_kernel<FT><<<grid, threads, smem, stream>>>(
      (const float *)zr, (const float *)zi, (const float *)F,
      (const float2 *)tw, (float *)yr, (float *)yi, n_out, log2n);
  return (int)cudaGetLastError();
}

// n_ch a power of two in [16, 1024] takes the FFT kernel and needs tw (Wtr
// and Wti may be null); any other even n_ch takes the matrix-DFT kernel
// and needs Wtr/Wti (tw may be null).  ops/chan_kernel._fft_path mirrors
// this choice to build only the tables the kernel reads.
extern "C" int launch_fold_dft(const void *zr, const void *zi, const void *F,
                               const void *tw, const void *Wtr,
                               const void *Wti, void *yr, void *yi, int n_out,
                               int n_ch, int n_s, void *stream) {
  if (n_ch <= 0 || n_ch % 2 || n_out <= 0 || n_s % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_ch >= 16 && n_ch <= 1024 && (n_ch & (n_ch - 1)) == 0) {
    if (n_s != 2 * TPB || tw == nullptr) return (int)cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < n_ch) ++log2n;
    if (n_ch <= FFT_POINTS / 16)
      return launch_fold_fft<16>(zr, zi, F, tw, yr, yi, n_out, n_ch, log2n,
                                 st);
    if (n_ch == FFT_POINTS / 8)
      return launch_fold_fft<8>(zr, zi, F, tw, yr, yi, n_out, n_ch, log2n,
                                st);
    return launch_fold_fft<4>(zr, zi, F, tw, yr, yi, n_out, n_ch, log2n, st);
  }
  if (Wtr == nullptr || Wti == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = 2 * (size_t)TM * n_ch * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fold_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_out + TM - 1) / TM);
  fold_dft_kernel<<<grid, FOLD_THREADS, smem, st>>>(
      (const float *)zr, (const float *)zi, (const float *)F,
      (const float *)Wtr, (const float *)Wti, (float *)yr, (float *)yi, n_out,
      n_ch, n_s);
  return (int)cudaGetLastError();
}

extern "C" int launch_resample(const void *xr, const void *xi, const void *hr,
                               const void *hi, const void *coef,
                               const void *off, void *yr, void *yi, int t_out,
                               int C, int L, int M, int ntap, int pad,
                               void *stream) {
  if (C <= 0 || t_out <= 0 || t_out > 65535) return (int)cudaErrorInvalidValue;
  dim3 block(128);
  dim3 grid((C + 127) / 128, t_out);
  resample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float *)xr, (const float *)xi, (const float *)hr,
      (const float *)hi, (const float *)coef, (const int *)off, (float *)yr,
      (float *)yi, t_out, C, L, M, ntap, pad);
  return (int)cudaGetLastError();
}
