// int8 x int8 -> int32 matrix product for Hopper (sm_90a): K6.
//
// Replaces: paddle_tpu/ops/quant_ops.py::_pallas_int8_matmul (K6, the
// inner `kernel` launched by its pl.pallas_call). Same function:
// out[M, N] = xq[M, K] @ wq[K, N], int8 operands, exact int32 sums
// (|x|, |w| <= 127, so K up to about 2^17 cannot overflow). The caller
// (ops/quant_ops.py::int8_matmul) quantizes the activations and
// rescales the int32 result outside the kernel, as the reference does.
//
// What bounds it on an H100: 2 * M * K * N integer operations against
// (M * K + K * N + 4 * M * N) bytes. At the GPT-2-small serving shapes
// (M = 8192) the four block products are operation-bound against the
// 1979 TOP/s dense int8 tensor-core peak (0.03-0.04 ms each); the lm
// head (N = 50304) is byte-bound by its 1.65 GB int32 output (about
// 0.5 ms at 3.35 TB/s).
//
// Design. The TPU grid sweeps K sequentially with an int32 VMEM
// accumulator per 128 x 128 output tile; here one block of 256 threads
// owns a 128 x 128 output tile and loops over K itself, the sums in
// registers:
//   * 8 warps as 2 (M) x 4 (N); each warp owns a 64 x 32 sub-tile, 4 x 4
//     tensor-core products `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8
//     .s32` per 32-deep step, 64 int32 accumulators a thread;
//   * each 64-deep K step stages the x tile [128][64] and the w tile in
//     shared memory, both k-contiguous (the layout the mma fragments
//     read: four consecutive k bytes of one row or column in one 32-bit
//     register). x is row-major [M, K] and lands as it is read. w is
//     [K, N] with N contiguous: each thread reads a 4 (k) x 4 (n) block
//     as four 32-bit words and transposes it with __byte_perm into four
//     k-contiguous words, one per column — no transposed copy of the
//     weight is made in device memory;
//   * rows are padded to 80 bytes, so the fragment reads of a warp hit
//     32 distinct banks;
//   * two shared-memory stages: each thread loads the next step's share
//     into registers while the current step is multiplied (one barrier
//     a step).
// Ragged edges (M, N, K not multiples of the tile) are bounds-checked
// and zero-filled. When K and N are multiples of 16 and the operands
// are 16-byte aligned, the loads are 16-byte (x) and 4-byte (w) words;
// otherwise byte by byte. wgmma, TMA and a fused rescale epilogue are
// later work.
//
// Interface: plain C, bound with ctypes. xq is contiguous [M, K] int8,
// wq contiguous [K, N] int8, out contiguous [M, N] int32. Returns
// cudaGetLastError() after the launch, -1 for negative sizes, -2 when M
// needs more than 65535 row tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 64;         // K depth of one staged step
constexpr int kThreads = 256;   // 8 warps: 2 (M) x 4 (N)
constexpr int kLd = kBK + 16;   // padded shared row in bytes
constexpr int kStage = (kBM + kBN) * kLd;   // x tile then w tile

// One thread's share of a K step, held in registers between the global
// loads and the shared-memory stores: two 16-byte chunks of x, two
// 4 x 4 byte blocks of w (word e = row k + e, columns n .. n + 3).
struct Share {
  uint4 a[2];
  uint32_t b[2][4];
};

template <bool kVec>
__device__ __forceinline__ void load_share(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, Share& sh) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    // x: 128 rows x 64 bytes = 512 chunks of 16 bytes
    const int idx = tid + c * kThreads;
    const int row = m0 + (idx >> 2), k = k0 + (idx & 3) * 16;
    if (kVec) {
      sh.a[c] = (row < M && k < K)
                    ? *reinterpret_cast<const uint4*>(
                          x + static_cast<long long>(row) * K + k)
                    : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k + q * 4 + e;
          if (row < M && kk < K)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        x[static_cast<long long>(row) * K + kk]))
                    << (8 * e);
        }
        v[q] = word;
      }
      sh.a[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    // w: 64 k x 128 n = 16 x 32 blocks of 4 x 4 bytes; neighbouring
    // threads take neighbouring column blocks (coalesced rows)
    const int idx = tid + c * kThreads;
    const int n = n0 + (idx & 31) * 4, k = k0 + (idx >> 5) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k + e;
      if (kVec) {
        sh.b[c][e] = (kk < K && n < N)
                         ? *reinterpret_cast<const uint32_t*>(
                               w + static_cast<long long>(kk) * N + n)
                         : 0u;
      } else {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kk < K && n + j < N)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        w[static_cast<long long>(kk) * N + n + j]))
                    << (8 * j);
        }
        sh.b[c][e] = word;
      }
    }
  }
}

__device__ __forceinline__ void store_share(const Share& sh, int8_t* xs,
                                            int8_t* ws) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kThreads;
    *reinterpret_cast<uint4*>(xs + (idx >> 2) * kLd + (idx & 3) * 16) =
        sh.a[c];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kThreads;
    const int nl = (idx & 31) * 4, kl = (idx >> 5) * 4;
    const uint32_t* r = sh.b[c];
    // 4 x 4 byte transpose: word j of the result holds column n + j's
    // bytes for k .. k + 3, lowest k in the lowest byte
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<uint32_t*>(ws + (nl + 0) * kLd + kl) =
        __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(ws + (nl + 1) * kLd + kl) =
        __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(ws + (nl + 2) * kLd + kl) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(ws + (nl + 3) * kLd + kl) =
        __byte_perm(t1, t3, 0x7632);
  }
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w, int32_t* __restrict__ out,
                   int M, int K, int N) {
  __shared__ __align__(16) int8_t smem[2][kStage];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group / thread in group
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Share sh;
  const int steps = (K + kBK - 1) / kBK;
  load_share<kVec>(x, w, M, K, N, m0, n0, 0, sh);
  store_share(sh, smem[0], smem[0] + kBM * kLd);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      load_share<kVec>(x, w, M, K, N, m0, n0, (s + 1) * kBK, sh);
    const int8_t* xs = smem[s & 1];
    const int8_t* ws = xs + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A fragment (16 x 32, row): a0 row g, k t*4..+3; a1 row g + 8;
      // a2, a3 the same rows at k 16 + t*4. B fragment (32 x 8, col):
      // b0 column g, k t*4..+3; b1 k 16 + t*4..+3.
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* pa = xs + (wm + i * 16 + g) * kLd + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(pa);
        a[i][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * kLd);
        a[i][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* pb = ws + (wn + j * 8 + g) * kLd + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(pb);
        b[j][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    if (s + 1 < steps) {
      int8_t* next = smem[(s + 1) & 1];
      store_share(sh, next, next + kBM * kLd);
    }
    // one barrier a step: the stage just read is rewritten two steps on
    __syncthreads();
  }

  // C fragment (16 x 8): c0, c1 row g, columns t*2, t*2 + 1; c2, c3 row
  // g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M || col >= N) continue;
        int32_t* o = out + static_cast<long long>(row) * N + col;
        if (kVec) {   // N % 16 == 0: the pair is in range and 8-byte aligned
          *reinterpret_cast<int2*>(o) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          o[0] = acc[i][j][2 * h];
          if (col + 1 < N) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

}  // namespace

extern "C" int pt_int8_matmul_s8s8s32(const void* x, const void* w,
                                      void* out, int M, int K, int N,
                                      void* stream) {
  if (M < 0 || K < 0 || N < 0) return -1;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return -2;
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec)
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(xp, wp, op, M, K, N);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(xp, wp, op, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
