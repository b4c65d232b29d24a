// LM-head log-sum-exp for Hopper (sm_90a), bfloat16 operands (amp
// training): K5.
//
// Replaces: paddle_tpu/ops/chunked_ce.py::_lse_kernel (K5, :90, launched
// by pallas_lse's pl.pallas_call :146) as the reference runs it under
// bf16 amp: lse[i] = logsumexp_c of (x @ w)[i, c] over the vocabulary,
// the products on bf16 operands accumulated in f32
// (preferred_element_type), an f32 online max / denominator per row over
// a sweep of vocab tiles; columns >= V are masked, and the [rows x cols]
// logits never leave the SM.
//
// What bounds it on an H100: 2 * N * H * V operations (633 GFLOP at the
// GPT-2-small training shape, N = 8192, H = 768, V = 50304): 0.64 ms at
// the 989 TFLOP/s of dense bf16 tensor cores, against (N * H + H * V) * 2
// + N * 4 bytes (0.09 ms). So it is bound by tensor-core operations.
//
// Design. The TPU grid sweeps the vocab axis sequentially per row block
// with the running max and denominator in VMEM scratch; here one block
// owns a 64-row tile (128 blocks at the training shape, about one per
// SM) and loops over the vocabulary itself:
//   * the row tile of x is staged once in shared memory ([64][H + 8]
//     bf16, 97 KB at H = 768) and read as A fragments by ldmatrix;
//   * w is streamed in [64 h x 128 column] chunks, double-buffered by
//     cp.async, and read as B fragments by ldmatrix.trans: w [H, V] is
//     stored with the reduction index down its rows, and 16-bit
//     ldmatrix.trans transposes the 8 x 8 blocks on the way, so no
//     transposed copy of w is made;
//   * 8 warps: 4 row groups of 16 x 2 column halves of 64; each warp's
//     16 x 64 logits live in f32 mma.sync m16n8k16 fragments until the
//     tile's last h chunk; then each row's max and sum of exponentials
//     are reduced over its quad by shuffles and folded into the warp's
//     running (m, s); the two column halves are merged at the end.
// expf / logf without fast math. wgmma and TMA are later work.
//
// Interface: plain C, bound with ctypes; the arguments of the f32 entry
// (lm_head_lse.cu) with bf16 tensors. x is [N, H] bf16 with row stride
// sx, w is [H, V] bf16 with row stride sw (H, V, sx and sw multiples of
// 8, rows 16-byte aligned: what a 16-byte cp.async needs), lse is
// contiguous f32 [N]. Returns cudaGetLastError() after the launch, or -1
// for H outside the kernel's range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows of x per block
constexpr int kCols = 128;     // vocab columns per logits tile
constexpr int kK = 64;         // depth of one streamed w chunk
constexpr int kThreads = 256;  // 4 row groups x 2 column halves
constexpr int kWS = kCols + 8; // w chunk row stride (bf16)
constexpr int kMaxH = 768;     // the wrapper's LSE_MAX_H

__global__ void __launch_bounds__(kThreads)
lse_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                float* __restrict__ lse, int N, int H, int V, long long sx,
                long long sw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Hp = (H + kK - 1) / kK * kK;
  const int XS = Hp + 8;                          // x tile row stride
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [64][XS]
  bf16* wc = xs + kRows * XS;                     // 2 x [64][kWS]
  __shared__ float m_s[kRows], s_s[kRows];        // column half 1's state

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wcol = warp >> 2;      // row group, column half
  const int row0 = blockIdx.x * kRows;

  // the x tile (rows past N and columns past H zero-filled)
  for (int i = threadIdx.x; i < kRows * (Hp / 8); i += kThreads) {
    const int r = i / (Hp / 8), c = 8 * (i % (Hp / 8));
    const bool live = row0 + r < N && c < H;
    bf::cp_async16(xs + r * XS + c,
                   x + (live ? (row0 + r) * sx + c : 0), live);
  }
  const int nkc = Hp / kK, steps = (V + kCols - 1) / kCols * nkc;
  auto load_chunk = [&](int step, int stage) {
    const int c0 = step / nkc * kCols, k0 = step % nkc * kK;
    bf16* dst = wc + stage * kK * kWS;
    for (int i = threadIdx.x; i < kK * (kCols / 8); i += kThreads) {
      const int r = i / (kCols / 8), c = 8 * (i % (kCols / 8));
      const bool live = k0 + r < H && c0 + c < V;
      bf::cp_async16(dst + r * kWS + c,
                     w + (live ? (k0 + r) * sw + c0 + c : 0), live);
    }
    bf::cp_async_commit();   // the first group also holds the x tile
  };
  load_chunk(0, 0);

  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8 (quad-shared)
  float s0 = 0.f, s1 = 0.f;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1;
    bf::cp_async_wait<0>();
    // chunk `step` is visible, and every warp is done with the stage
    // that the next load overwrites
    __syncthreads();
    if (step + 1 < steps) load_chunk(step + 1, stage ^ 1);
    const bf16* cur = wc + stage * kK * kWS;
    const int k0 = step % nkc * kK;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      uint32_t a[4];
      bf::load_a(a, xs, XS, 16 * wr, k0 + 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        bf::load_b_kn(b, cur, kWS, 16 * kk, 64 * wcol + 16 * np, lane);
        bf::mma(acc[2 * np], a, b);
        bf::mma(acc[2 * np + 1], a, b + 2);
      }
    }
    if (step % nkc != nkc - 1) continue;
    // a logits tile is complete: fold this warp's 64 columns of it into
    // its rows' running (max, denominator)
    const int c0 = step / nkc * kCols + 64 * wcol;
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c0 + 8 * nt + 2 * t + e < V) {
          t0 = fmaxf(t0, acc[nt][e]);
          t1 = fmaxf(t1, acc[nt][2 + e]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o));
    }
    // t0 == -inf: no live column in this half of the tile (the ragged
    // last tile); the state is left as it is
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c0 + 8 * nt + 2 * t + e < V) {
          u0 += expf(acc[nt][e] - n0);
          u1 += expf(acc[nt][2 + e] - n1);
        }
      }
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      u0 += __shfl_xor_sync(0xffffffffu, u0, o);
      u1 += __shfl_xor_sync(0xffffffffu, u1, o);
    }
    if (t0 != -INFINITY) {
      s0 = (m0 == -INFINITY ? 0.f : s0 * expf(m0 - n0)) + u0;
      m0 = n0;
    }
    if (t1 != -INFINITY) {
      s1 = (m1 == -INFINITY ? 0.f : s1 * expf(m1 - n1)) + u1;
      m1 = n1;
    }
  }

  // merge the two column halves of every row
  const int ra = 16 * wr + g, rb = ra + 8;
  if (wcol == 1 && t == 0) {
    m_s[ra] = m0;
    s_s[ra] = s0;
    m_s[rb] = m1;
    s_s[rb] = s1;
  }
  __syncthreads();
  if (wcol == 0 && t == 0) {
    const float mm[2] = {m0, m1}, ss[2] = {s0, s1};
    const int rr[2] = {ra, rb};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr[i];
      if (row0 + r >= N) continue;
      const float mo = m_s[r], so = s_s[r];
      const float m = fmaxf(mm[i], mo);   // finite: V >= 1
      const float s = (mm[i] == -INFINITY ? 0.f : ss[i] * expf(mm[i] - m)) +
                      (mo == -INFINITY ? 0.f : so * expf(mo - m));
      lse[row0 + r] = m + logf(s);
    }
  }
}

}  // namespace

extern "C" int pt_lm_head_lse_bf16(const void* x, const void* w, void* lse,
                                   int N, int H, int V, long long sx,
                                   long long sw, void* stream) {
  if (H < 1 || H > kMaxH) return -1;
  const int Hp = (H + kK - 1) / kK * kK;
  const int smem = static_cast<int>(sizeof(bf16)) *
                   (kRows * (Hp + 8) + 2 * kK * kWS);
  cudaError_t err = cudaFuncSetAttribute(
      lse_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRows - 1) / kRows);
  lse_bf16_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<float*>(lse), N, H, V, sx, sw);
  return static_cast<int>(cudaGetLastError());
}
