// K4 (fold + DFT + hop-phase flip) and the 18/25 polyphase resample that,
// after it, makes up K3: the wideband front end.
//
// Replaces the TPU kernels tetra_tpu/ops/chan_pallas.py:195 fold_dft (K4)
// and :144 fold_dft_resample (K3).  Semantics are the plain channelizer's
// (tetra_tpu_torch/ops/chan_kernel.fold_dft_plain and
// tetra_tpu_torch/parallel/channelizer._resample_stream_block_fm):
//
//   fold:  f[m, d*hop + c] = sum_j z[m + 2j + d, c] F[2j + d, c]
//   DFT:   y[m, k] = sum_b f[m, b] exp(-2 pi i b k / n_ch)
//   flip:  y[m, k] *= (-1)^(m k)
//   resample: out[18q + p, c] = sum_{t<24} coef[p, t] s[25q + off[p] + t, c]
//             over the stream s = [h (23-row history) | y (t50 rows)]; the
//             next block's history is y's last 23 rows
//
// K3 is two kernels behind one C entry point (launch_fold_dft_resample):
// the K4 kernel writes the frame-major 50 kHz rows y, then resample_kernel
// reads them.  The TPU kernel is one launch because its grid runs in order
// and carries the resampler's 25-row halo in VMEM from step to step.
// Blocks on the card run in no order, so one fused kernel would either
// fold and FFT each block's 23 halo frames again (46% more fold + FFT work
// at 2 resample groups a block; at 4, only 64 blocks for 132 SMs, one a
// SM by shared memory), or wait on the previous block's frames through
// flags (spin waits, ordered block tickets).  Both cost more than what
// they save: one launch, and one read of 13 MB that the K4 kernel has just
// written and that stays in the 50 MB L2.
//
// The resample is bound by bytes: y and h in, the 36 kHz rows and the
// tails out, 22.6 MB at n_ch = 256, t50 = 6400, against 0.11 G FP32
// operations.  resample_kernel's tile plan: a block of 256 threads takes
// 32 channels (lane = channel) and 8 resample groups (25 input, 18 output
// rows each).  It stages the stream rows 25 q0 .. 25 q0 + 222 of its
// channels in shared memory (re and im as [row][32] arrays, 57 KB; rows
// below 23 come from h), so each y row is read from L2 once plus the
// 23-row halo, where reading the taps straight from memory read it ~17
// times.  Warp w makes the block's outputs w, w + 8, ...: the phase p is
// the same over the warp, so each tap is a broadcast from shared memory,
// and each output sums its 24 taps in tap order with fmaf.  The stores
// are coalesced; lanes past C and groups past the stream's end are
// masked.  The block that holds y's last 23 rows (the last group tile;
// it stages one row more than its outputs read for that) writes them as
// the next block's history.
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

#include "cp_async.cuh"

#define TM 16
#define FOLD_THREADS 256
#define TPB 48            // taps per branch: channelizer.TAPS_PER_BRANCH
#define FFT_THREADS 256
#define FFT_POINTS 4096   // FT * n_ch of the FFT kernel's blocks above 256
#define RS_L 18           // resample: output rows a group
#define RS_M 25           // input rows a group
#define RS_TAPS 24        // channelizer.RS_TAPS_PER_PHASE
#define RS_PAD 23         // history rows: RS_TAPS - 1
#define RS_CT 32          // channels a block: one warp width
#define RS_G 8            // resample groups a block
#define RS_THREADS 256
#define RS_ROWS (RS_M * RS_G + RS_PAD)  // stream rows a block stages

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

// Two blocks an SM cap a thread at 128 registers.  FT = 8 (n_ch = 512)
// spilled 568 B there and took 0.181 ms a 6400-frame block on the H100;
// at one block an SM it takes 255 registers, spills 20 B and takes
// 0.123 ms (its smem of 69.6 KB a block would allow three).  FT = 4 and
// 16 fit in 128 without a spill.
template <int FT>
__global__ void __launch_bounds__(FFT_THREADS, FT == 8 ? 1 : 2)
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

// Grid (ceil(C / 32), ceil(t_in / 25 / 8)): block (x, y) takes channels
// 32 x .. 32 x + 31 and groups 8 y .. 8 y + 7 (the head note's tile plan).
__global__ void __launch_bounds__(RS_THREADS)
resample_kernel(const float *__restrict__ xr,
                const float *__restrict__ xi,    // (t_in, C): y
                const float *__restrict__ hr,
                const float *__restrict__ hi,    // (RS_PAD, C): history
                const float *__restrict__ coef,  // (RS_L, RS_TAPS)
                const int *__restrict__ off,     // (RS_L,)
                float *__restrict__ yr,
                float *__restrict__ yi,          // (t_out, C)
                float *__restrict__ tr,
                float *__restrict__ ti,          // (RS_PAD, C): next history
                int t_in, int C) {
  extern __shared__ float4 sm4[];
  float(*sr)[RS_CT] = reinterpret_cast<float(*)[RS_CT]>(sm4);
  float(*si)[RS_CT] = sr + RS_ROWS;
  float *cs = &si[RS_ROWS][0];  // [RS_L][RS_TAPS], 16-byte aligned
  int *os = reinterpret_cast<int *>(cs + RS_L * RS_TAPS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = RS_THREADS / 32;
  const int c = blockIdx.x * RS_CT + lane;
  const int q0 = blockIdx.y * RS_G;
  const int g = min(RS_G, t_in / RS_M - q0);    // groups in this tile
  const int e0 = q0 * RS_M;                     // first staged stream row
  const int rows = g * RS_M + RS_PAD;  // the last tile's reach the
                                       // stream's end
  // Stage stream rows e0 .. e0 + rows - 1, a warp a row (128 B, lane =
  // channel); which source a row comes from is uniform over the warp.
  if (c < C) {
    for (int r = warp; r < rows; r += n_warps) {
      const int e = e0 + r;
      const bool hist = e < RS_PAD;
      const size_t at = (size_t)(hist ? e : e - RS_PAD) * C + c;
      cp_async4(&sr[r][lane], (hist ? hr : xr) + at);
      cp_async4(&si[r][lane], (hist ? hi : xi) + at);
    }
  }
  for (int i = threadIdx.x; i < RS_L * RS_TAPS; i += RS_THREADS)
    cs[i] = coef[i];
  if (threadIdx.x < RS_L) os[threadIdx.x] = off[threadIdx.x];
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();

  // Output j = 18 ql + p of the tile reads staged rows 25 ql + off[p] + t.
  for (int j = warp; j < g * RS_L; j += n_warps) {
    const int ql = j / RS_L, p = j - ql * RS_L;
    const int base = ql * RS_M + os[p];
    const float4 *w4 = reinterpret_cast<const float4 *>(cs + p * RS_TAPS);
    float ar = 0.0f, ai = 0.0f;
#pragma unroll
    for (int t4 = 0; t4 < RS_TAPS / 4; ++t4) {
      const float4 w = w4[t4];
      const int r = base + 4 * t4;
      ar = fmaf(w.x, sr[r][lane], ar);
      ai = fmaf(w.x, si[r][lane], ai);
      ar = fmaf(w.y, sr[r + 1][lane], ar);
      ai = fmaf(w.y, si[r + 1][lane], ai);
      ar = fmaf(w.z, sr[r + 2][lane], ar);
      ai = fmaf(w.z, si[r + 2][lane], ai);
      ar = fmaf(w.w, sr[r + 3][lane], ar);
      ai = fmaf(w.w, si[r + 3][lane], ai);
    }
    if (c < C) {
      const size_t n = (size_t)q0 * RS_L + j;
      yr[n * C + c] = ar;
      yi[n * C + c] = ai;
    }
  }

  // The last tile holds the stream's last RS_PAD rows (y's last rows):
  // the next block's history.
  if (blockIdx.y == gridDim.y - 1 && c < C) {
    for (int r = warp; r < RS_PAD; r += n_warps) {
      tr[(size_t)r * C + c] = sr[g * RS_M + r][lane];
      ti[(size_t)r * C + c] = si[g * RS_M + r][lane];
    }
  }
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

// The resample's group tiles (the grid's y dimension), or 0 for a shape it
// does not take: t_in a positive multiple of 25 and t_out = t_in * 18 / 25.
static int resample_tiles(int t_in, int t_out, int C) {
  if (C <= 0 || t_in <= 0 || t_in % RS_M || t_out != t_in / RS_M * RS_L)
    return 0;
  const int tiles = (t_in / RS_M + RS_G - 1) / RS_G;
  return tiles <= 65535 ? tiles : 0;
}

// x (t_in, C) and the (RS_PAD, C) history h in; the (t_out, C) rows y and
// the next block's history t out.  t may not alias h.
extern "C" int launch_resample(const void *xr, const void *xi, const void *hr,
                               const void *hi, const void *coef,
                               const void *off, void *yr, void *yi, void *tr,
                               void *ti, int t_in, int t_out, int C,
                               void *stream) {
  const int tiles = resample_tiles(t_in, t_out, C);
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  const int smem = (2 * RS_ROWS * RS_CT + RS_L * RS_TAPS + RS_L) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + RS_CT - 1) / RS_CT, tiles);
  resample_kernel<<<grid, RS_THREADS, smem, (cudaStream_t)stream>>>(
      (const float *)xr, (const float *)xi, (const float *)hr,
      (const float *)hi, (const float *)coef, (const int *)off, (float *)yr,
      (float *)yi, (float *)tr, (float *)ti, t_in, C);
  return (int)cudaGetLastError();
}

// K3: the K4 kernel (launch_fold_dft's choice of path) writes the 50 kHz
// rows into the scratch y (n_out, n_ch), then the resample kernel reads
// them, on one stream.  Returns the first non-zero cudaError_t; a shape
// the resample does not take is refused before either launch.
extern "C" int launch_fold_dft_resample(
    const void *zr, const void *zi, const void *F, const void *tw,
    const void *Wtr, const void *Wti, void *y_r, void *y_i, const void *hr,
    const void *hi, const void *coef, const void *off, void *rr, void *ri,
    void *tr, void *ti, int n_out, int n_ch, int n_s, int t_out,
    void *stream) {
  if (resample_tiles(n_out, t_out, n_ch) == 0)
    return (int)cudaErrorInvalidValue;
  const int e = launch_fold_dft(zr, zi, F, tw, Wtr, Wti, y_r, y_i, n_out,
                                n_ch, n_s, stream);
  if (e != 0) return e;
  return launch_resample(y_r, y_i, hr, hi, coef, off, rr, ri, tr, ti, n_out,
                         t_out, n_ch, stream);
}
