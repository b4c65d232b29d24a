// LM-head log-sum-exp for Hopper (sm_90a), float32: K5.
//
// Replaces: paddle_tpu/ops/chunked_ce.py::_lse_kernel (K5, :90, launched
// by pallas_lse's pl.pallas_call :146). Same function: lse[i] =
// logsumexp_c of (x @ w)[i, c] over the vocabulary, an online
// max/denominator per row over a sweep of vocab tiles; columns >= V are
// masked, so V needs no padding, and the [rows x cols] logits never leave
// the SM. The reference takes the product in f32
// (preferred_element_type); so does this kernel, on the tensor cores.
//
// What bounds it on an H100: 2 * N * H * V operations (6.3e11 at the
// GPT-2-small training shape, N = 8192, H = 768, V = 50304) against
// (N * H + H * V + N) * 4 bytes (0.19 GB). f32 FMA (67 TFLOP/s) would take
// 9.4 ms; f32-accurate products on the TF32 tensor cores take three TF32
// products each (3xTF32, tf32_mma.cuh): 3.8 ms at 495 / 3 TFLOP/s. So it is
// bound by tensor-core operations.
//
// Design. The TPU grid sweeps the vocab axis sequentially per row block
// with the running max and denominator in VMEM scratch; here a block owns
// a 128-row tile and one split of the vocabulary, and sweeps the split's
// 128-column logits tiles itself:
//   * x and w are streamed in 64-deep k chunks ([128 x 64] of x, [64 x
//     128] of w) through a 3-stage cp.async ring (16 bytes a thread,
//     zero-filled past N, H and V, so unwritten memory never enters a
//     product); x is re-read for each logits tile, from L2;
//   * 8 warps, 2 row halves x 4 column quarters: each warp's 64 x 32
//     logits are 3xTF32 mma.sync.m16n8k8 fragments (split_rz: lo left for
//     the tensor core to truncate); A fragments of x by ldmatrix (an 8 x 4
//     f32 block is an 8 x 8 b16 one), B of w by 32-bit loads (row strides
//     68 and 136 floats: no bank conflicts);
//   * the product over H is summed one 64-wide k tile at a time into a
//     fresh fragment and the tiles' sums are added in f32 by the SIMT
//     cores (the error of a tensor-core chain grows with its length;
//     tf32_mma.cuh);
//   * after a logits tile, each row's max and sum of exponentials over
//     the warp's 32 columns are reduced over its quad by shuffles and
//     folded into the thread's running (m, s); the four column quarters
//     are merged in order at the end and the block writes its split's
//     (m, s) per row to scratch;
//   * the grid runs the row block fastest, so the blocks resident at one
//     time read the same few vocab splits of w (154.5 MB at the training
//     shape, three times the L2) out of L2; the splits give ~16 blocks an
//     SM (one resident at a time: 216-217 registers a thread hold a warp's
//     fresh fragment and its running sum) so the last wave is a small
//     share;
//   * a second kernel merges each row's splits in split order and writes
//     lse = m + log(s): the result is the same bits from run to run.
// expf / logf without fast math.
//
// Interface: plain C, bound with ctypes. x is [N, H] float32 with row
// stride sx (H and sx multiples of 4, rows 16-byte aligned), w is [H, V]
// float32 with row stride sw (read 16 bytes at a time when sw and V are
// multiples of 4 and w is 16-byte aligned, else 4), lse is contiguous
// [N], scratch holds 2 * splits * N floats. Returns cudaGetLastError()
// after the launches, or -1 for H outside the kernel's range.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 128;      // rows of x per block
constexpr int kCols = 128;      // vocab columns per logits tile
constexpr int kK = 64;          // depth of one streamed k chunk
constexpr int kStages = 3;      // k chunks in flight
constexpr int kKTile = 64;      // depth of one fresh fragment's sum
constexpr int kPer = kKTile / kK;   // k chunks a fresh fragment
constexpr int kThreads = 256;   // 2 row halves x 4 column quarters
constexpr int kXS = kK + 4;     // x chunk row stride (floats)
constexpr int kWS = kCols + 8;  // w chunk row stride (floats)
constexpr int kStageFloats = kRows * kXS + kK * kWS;
constexpr int kMaxH = 768;      // the wrapper's LSE_MAX_H

// four 8 x 8 b16 blocks of shared memory (row addresses from the lanes
// of each eight): as f32, rows g / g + 8 x columns t / t + 4 of a 16 x 8
// tile, the m16n8k8 tf32 A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

// c = a.b (tf32), the accumulator input zero: the first product of a
// fresh fragment
__device__ __forceinline__ void mma_tf32_zero(float c[4],
                                              const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc (a warp's 64 x 32 tile: [m-tile][n-tile][fragment]) += the x rows .
// w columns of one staged k chunk, in 3xTF32; kFresh: acc starts at zero
template <bool kFresh>
__device__ __forceinline__ void chunk_product(float (&acc)[4][4][4],
                                              const float* xs,
                                              const float* ws, int wr,
                                              int wc, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows: lanes 0-15 rows 0-15 at k 0, lanes 16-31 at k 4
  const float* xa = xs + (64 * wr + (lane & 15)) * kXS + 4 * (lane >> 4);
  const float* wb = ws + t * kWS + 32 * wc + g;
#pragma unroll
  for (int ks = 0; ks < kK / 8; ++ks) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t r[4];
      ldsm_x4(r, xa + 16 * mt * kXS + 8 * ks);
      tc::split_a<false>(__uint_as_float(r[0]), __uint_as_float(r[1]),
                         __uint_as_float(r[2]), __uint_as_float(r[3]),
                         ah[mt], al[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh[2], bl[2];
      tc::split_b<false>(wb[8 * ks * kWS + 8 * nt],
                         wb[(8 * ks + 4) * kWS + 8 * nt], bh, bl);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (kFresh && ks == 0) {
          mma_tf32_zero(acc[mt][nt], al[mt], bh);
          tc::mma_tf32(acc[mt][nt], ah[mt], bl);
          tc::mma_tf32(acc[mt][nt], ah[mt], bh);
        } else {
          tc::mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    }
  }
}

// the (m, s) of every row of a 128-row block over one vocab split:
// part_m / part_s [split][N]
template <bool kVecW>
__global__ void __launch_bounds__(kThreads, 1)
lse_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ part_m, float* __restrict__ part_s, int N,
           int H, int V, long long sx, long long sw, int tiles_per_split) {
  extern __shared__ __align__(16) float sm[];
  float* red = sm + kStages * kStageFloats;   // [4 quarters][kRows][2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;    // row half, column quarter
  const int row0 = blockIdx.x * kRows;
  const int ntiles = (V + kCols - 1) / kCols;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tiles = min(tiles_per_split, ntiles - tile0);
  const int nkc = (H + kKTile - 1) / kKTile * kPer;  // whole k tiles
  const int chunks = tiles * nkc;

  // chunk c of the sweep (logits tile c / nkc, k chunk c % nkc) into its
  // stage; past N, H or V zero-filled
  auto load = [&](int c) {
    float* xs = sm + (c % kStages) * kStageFloats;
    float* ws = xs + kRows * kXS;
    const int col0 = (tile0 + c / nkc) * kCols, k0 = (c % nkc) * kK;
    for (int i = threadIdx.x; i < kRows * kK / 4; i += kThreads) {
      const int r = i / (kK / 4), kq = 4 * (i % (kK / 4));
      const bool live = row0 + r < N && k0 + kq < H;
      tc::cp_async16(xs + r * kXS + kq,
                     x + (live ? (row0 + r) * sx + k0 + kq : 0), live);
    }
    if (kVecW) {
      for (int i = threadIdx.x; i < kK * kCols / 4; i += kThreads) {
        const int kr = i >> 5, cq = 4 * (i & 31);
        const bool live = k0 + kr < H && col0 + cq < V;
        tc::cp_async16(ws + kr * kWS + cq,
                       w + (live ? (k0 + kr) * sw + col0 + cq : 0), live);
      }
    } else {
      for (int i = threadIdx.x; i < kK * kCols; i += kThreads) {
        const int kr = i >> 7, cc = i & (kCols - 1);
        const bool live = k0 + kr < H && col0 + cc < V;
        tc::cp_async4(ws + kr * kWS + cc,
                      w + (live ? (k0 + kr) * sw + col0 + cc : 0), live);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    tc::cp_async_commit();
  }

  // this thread's rows: 64 wr + 16 mt + g + 8 half, r = 2 mt + half
  float m[8], s[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  float sum[4][4][4], acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;

  // one staged chunk: wait for it, start the load kStages - 1 ahead (into
  // the stage every warp finished with before the barrier), multiply
  auto step = [&](int c, auto fresh) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    tc::cp_async_commit();
    const float* xs = sm + (c % kStages) * kStageFloats;
    chunk_product<decltype(fresh)::value>(acc, xs, xs + kRows * kXS, wr, wc,
                                          lane);
  };
  // the sweep, one 64-wide k tile (kPer chunks) at a time
  for (int c = 0; c < chunks; c += kPer) {
    step(c, std::true_type{});
#pragma unroll
    for (int j = 1; j < kPer; ++j) step(c + j, std::false_type{});
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] += acc[mt][nt][e];
    if ((c + kPer) % nkc != 0) continue;
    // a logits tile is complete: fold each row's 32 columns of it into
    // the running (m, s); columns past V are masked
    const int col0 = (tile0 + c / nkc) * kCols + 32 * wc + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 2 * mt + half;
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * nt + e < V)
              tmax = fmaxf(tmax, sum[mt][nt][2 * half + e]);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float mn = fmaxf(m[r], tmax);
        // a quarter with no live column yet keeps m = -inf, s = 0
        const float base = mn == -INFINITY ? 0.f : mn;
        float ts = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * nt + e < V)
              ts += expf(sum[mt][nt][2 * half + e] - base);
        ts += __shfl_xor_sync(0xffffffffu, ts, 1);
        ts += __shfl_xor_sync(0xffffffffu, ts, 2);
        s[r] = s[r] * expf(m[r] - base) + ts;
        m[r] = mn;
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
  }

  // merge the four column quarters of each row, in quarter order
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = 64 * wr + 16 * (r >> 1) + (lane >> 2) + 8 * (r & 1);
      red[2 * (wc * kRows + row)] = m[r];
      red[2 * (wc * kRows + row) + 1] = s[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows && row0 + threadIdx.x < N) {
    float mq[4], mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mq[q] = red[2 * (q * kRows + threadIdx.x)];
      mx = fmaxf(mx, mq[q]);
    }
    float sx_ = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (mq[q] > -INFINITY)
        sx_ += red[2 * (q * kRows + threadIdx.x) + 1] * expf(mq[q] - mx);
    const long long at = (long long)blockIdx.y * N + row0 + threadIdx.x;
    part_m[at] = mx;
    part_s[at] = sx_;
  }
}

// lse of each row from its splits' (m, s), merged in split order
__global__ void lse_merge_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_s,
                                 float* __restrict__ lse, int N,
                                 int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = -INFINITY;
  for (int j = 0; j < splits; ++j)
    mx = fmaxf(mx, part_m[(long long)j * N + row]);
  float sum = 0.f;
  for (int j = 0; j < splits; ++j) {
    const float mj = part_m[(long long)j * N + row];
    if (mj > -INFINITY) sum += part_s[(long long)j * N + row] * expf(mj - mx);
  }
  lse[row] = mx + logf(sum);
}

template <bool kVecW>
cudaError_t launch_lse(dim3 grid, size_t smem, cudaStream_t stream,
                       const float* x, const float* w, float* part_m,
                       float* part_s, int N, int H, int V, long long sx,
                       long long sw, int tiles_per_split) {
  const cudaError_t err = cudaFuncSetAttribute(
      lse_kernel<kVecW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lse_kernel<kVecW><<<grid, kThreads, smem, stream>>>(
      x, w, part_m, part_s, N, H, V, sx, sw, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

// scratch: 2 * splits * N floats (the splits' m, then their s); `splits`
// is the most the caller allows: the vocab tiles are dealt out evenly, so
// the kernel may use fewer
extern "C" int pt_lm_head_lse_f32(const void* x, const void* w, void* lse,
                                  void* scratch, int N, int H, int V,
                                  long long sx, long long sw, int splits,
                                  void* stream) {
  if (H < 1 || H > kMaxH || splits < 1) return -1;
  const int ntiles = (V + kCols - 1) / kCols;
  const int per = (ntiles + splits - 1) / splits;
  const int used = (ntiles + per - 1) / per;
  float* part_m = static_cast<float*>(scratch);
  float* part_s = part_m + static_cast<long long>(splits) * N;
  const size_t smem = sizeof(float) * (kStages * kStageFloats + 4 * kRows * 2);
  const dim3 grid((N + kRows - 1) / kRows, used);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const bool vec = sw % 4 == 0 && V % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err =
      vec ? launch_lse<true>(grid, smem, s, xf, wf, part_m, part_s, N, H, V,
                             sx, sw, per)
          : launch_lse<false>(grid, smem, s, xf, wf, part_m, part_s, N, H, V,
                              sx, sw, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      part_m, part_s, static_cast<float*>(lse), N, used);
  return static_cast<int>(cudaGetLastError());
}
