// LM-head log-sum-exp for Hopper (sm_90a), float32: K5.
//
// Replaces: paddle_tpu/ops/chunked_ce.py::_lse_kernel (K5, launched by
// pallas_lse's pl.pallas_call). Same function: lse[i] = logsumexp_c of
// (x @ w)[i, c] over the vocabulary, an online max/denominator per row
// over a sweep of vocab tiles; columns >= V are masked, so V needs no
// padding, and the [rows x cols] logits never leave the SM.
//
// What bounds it on an H100: 2 * N * H * V operations (6.3e11 at the
// GPT-2-small training shape, N = 8192, H = 768, V = 50304) against
// (N * H + H * V + N) * 4 bytes; in float32 there are no tensor cores,
// so it is bounded by the card's 67 TFLOP/s of f32 FMA (about 9.4 ms).
//
// Design. The TPU grid sweeps the vocab axis sequentially per row block
// with the running max and denominator in VMEM scratch; here one block
// owns a 64-row tile (N / 64 = 128 blocks at the training shape, about
// one per SM) and loops over the vocabulary itself:
//   * the row tile of x is staged once in shared memory, transposed
//     ([H][64], 192 KB at H = 768: the reason H <= 768 here), and w is
//     streamed through two [16 x 256] shared-memory chunks: each thread
//     loads its share of the next chunk into registers while the
//     current one is multiplied (one barrier per chunk);
//   * 256 threads, warp w owning 8 rows and each lane 8 columns of
//     every [64 x 256] logits tile: an 8 x 8 share computed with f32
//     FMAs from four float4 shared reads per k (16 FMAs a read);
//   * per tile, each row's max and sum of exponentials are reduced over
//     its warp by shuffles and folded into the running state (m, s);
//     the block writes lse = m + log(s) at the end.
// The arithmetic is plain f32 FMAs with expf/logf (no fast math); wgmma
// and TMA are later work.
//
// Interface: plain C, bound with ctypes. x is [N, H] float32 with row
// stride sx (H a multiple of 4, rows 16-byte aligned), w is [H, V]
// float32 with row stride sw, lse is contiguous [N]. Returns
// cudaGetLastError() after the launch, or -1 for H outside the kernel's
// range.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // rows of x per block
constexpr int kCols = 256;     // vocab columns per logits tile
constexpr int kK = 16;         // depth of one staged w chunk
constexpr int kThreads = 256;  // 8 row groups x 32 column lanes
constexpr int kMaxH = 768;     // xt + two w chunks within 227 KB

__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ lse, int N, int H, int V, long long sx,
           long long sw) {
  extern __shared__ __align__(16) float sm[];
  const int Hp = (H + kK - 1) / kK * kK;
  float* xt = sm;                 // [Hp][64]: xt[k * 64 + r] = x[row0 + r][k]
  float* wc = sm + Hp * kRows;    // 2 x [16][256]: double-buffered w chunks

  // warp ty owns rows ty*8 .. ty*8+7; lane tx owns columns tx*4 .. +3
  // and 128 + tx*4 .. +3 of every tile (float4 reads, no bank conflict)
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;

  for (int idx = threadIdx.x; idx < kRows * (Hp / 4); idx += kThreads) {
    const int r = idx & (kRows - 1), k4 = idx >> 6;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N && 4 * k4 < H)
      val = reinterpret_cast<const float4*>(x + (row0 + r) * sx)[k4];
    xt[(4 * k4 + 0) * kRows + r] = val.x;
    xt[(4 * k4 + 1) * kRows + r] = val.y;
    xt[(4 * k4 + 2) * kRows + r] = val.z;
    xt[(4 * k4 + 3) * kRows + r] = val.w;
  }

  // the sweep is a sequence of (vocab tile, k chunk) steps; each
  // thread prefetches its 16 elements of the next step's w chunk into
  // registers while the current chunk is multiplied, so the global
  // loads' latency hides behind the FMAs
  const int nkc = Hp / kK, steps = (V + kCols - 1) / kCols * nkc;
  constexpr int kPer = kK * kCols / kThreads;   // = kK: one row each
  float pre[kPer];
  auto fetch = [&](int t) {
    const int c0 = t / nkc * kCols, k0 = t % nkc * kK;
    const int col = c0 + threadIdx.x;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int kr = k0 + e;
      pre[e] = (kr < H && col < V) ? w[kr * sw + col] : 0.f;
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) buf[e * kCols + threadIdx.x] = pre[e];
  };
  fetch(0);
  stash(wc);
  __syncthreads();  // xt and the first chunk are staged

  float m[8], s[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) fetch(t + 1);
    const float* cur = wc + (t & 1) * kK * kCols;
    const int k0 = t % nkc * kK;
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      const float* xa = xt + (k0 + kk) * kRows + ty * 8;
      const float4 a0 = *reinterpret_cast<const float4*>(xa);
      const float4 a1 = *reinterpret_cast<const float4*>(xa + 4);
      const float* wb = cur + kk * kCols + tx * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(wb);
      const float4 b1 = *reinterpret_cast<const float4*>(wb + 128);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < steps) stash(wc + ((t + 1) & 1) * kK * kCols);
    if (t % nkc == nkc - 1) {
      // a logits tile is complete: fold it into each row's running
      // (max, denominator); a row's 256 columns live in one warp
      const int c0 = t / nkc * kCols;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + j - 4);
          if (col < V) tmax = fmaxf(tmax, acc[i][j]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(m[i], tmax);  // finite: c0 < V
        float tsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + j - 4);
          if (col < V) tsum += expf(acc[i][j] - m_new);
          acc[i][j] = 0.f;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
        s[i] = s[i] * expf(m[i] - m_new) + tsum;
        m[i] = m_new;
      }
    }
    // one barrier a step: the chunk just read is rewritten two steps on
    __syncthreads();
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty * 8 + i;
      if (row < N) lse[row] = m[i] + logf(s[i]);
    }
  }
}

}  // namespace

extern "C" int pt_lm_head_lse_f32(const void* x, const void* w, void* lse,
                                  int N, int H, int V, long long sx,
                                  long long sw, void* stream) {
  if (H < 1 || H > kMaxH) return -1;
  const int Hp = (H + kK - 1) / kK * kK;
  const size_t smem = sizeof(float) * (Hp * kRows + 2 * kK * kCols);
  cudaError_t err = cudaFuncSetAttribute(
      lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows);
  lse_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(lse), N, H, V, sx, sw);
  return static_cast<int>(cudaGetLastError());
}
