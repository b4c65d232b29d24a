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
// GPT-2-small training shape, N = 8192, H = 768, V = 50304): 0.640 ms at
// the 989 TFLOP/s of dense bf16 tensor cores, against (N * H + H * V) * 2
// + N * 4 bytes of HBM (0.09 ms). So it is bound by tensor-core
// operations. The traffic between L2 and the SMs comes next: w (77.3 MB
// of bf16) does not fit the 50 MB L2, and a tiled product streams
// w_bytes * ceil(N / BM) + x_bytes * ceil(V / BN) from it: 9.9 GB at
// 128 x 128 tiles, 7.4 GB at 128 x 256, ~4.95 GB when a 2-block cluster
// shares each w tile. On an H100 (tools/flash_ab.py lse16, PERF.md) the
// 128 x 256 tile took 0.88 ms, 128 x 128 1.18, and the cluster below
// 0.865; the variants are not kept in the code.
//
// Design (warp-specialised, persistent, wgmma + TMA; hopper.cuh):
//   * a work unit is (row block of 128 rows, vocab split): the (max,
//     denominator) of each row over the split's 256-column logits tiles,
//     written to an f32 scratch [2][splits][N]; a second kernel merges
//     each row's splits in split order and writes lse = m + log(s), so
//     the result is the same bits in every call (no atomics);
//   * a cluster of two blocks takes the units of two adjacent row blocks
//     and one split; the clusters walk the units row-pair fastest, so the
//     units in flight read the same few w tiles from L2;
//   * one producer warp per block streams x [128 rows x 64 k] and w [64 k
//     x 256 columns] by TMA (128-byte swizzle, zero fill past N, H and V)
//     through a 4-stage ring of full / empty mbarriers that runs on across
//     tiles and units; each block loads half of the w tile and multicasts
//     it to both blocks of its cluster, so a w tile leaves L2 once for 256
//     rows; a stage is free when the consumer warps of both blocks have
//     released it (one arrival a warp, local and on the other block's
//     barrier with a CTA-scope release: a cluster-scope one made the
//     kernel 35 % slower), and the producer waits for its last stages'
//     releases before the block exits;
//   * two consumer warpgroups of 64 rows each run wgmma m64n256k16 from
//     shared memory: x K-major as it is, w [H, V] row-major read MN-major
//     through the descriptor's transpose bit (four 64-column groups 8 KB
//     apart), so no transposed copy of w is made; 128 f32 accumulators a
//     thread, one wgmma group in flight;
//   * after a tile's ceil(H / 64) k-steps (12 at H 768, 16 at H 1024; H
//     has no upper bound, nothing here is sized by it, and a ragged last
//     step reads TMA's zero fill) its logits are folded into each
//     row's running (m, l): columns >= V set to -inf, the tile's row max
//     over a quad by shuffles, then exp2(fma(v, log2 e, -m log2 e)) by
//     the special-function unit (hp::exp2_approx), summed into four
//     partial sums a row in a fixed order;
//   * a 128-register accumulator leaves no room for a second one, so the
//     fold cannot overlap the next tile's products in its own warpgroup;
//     the two consumers are not kept in step, so one's fold may run beside
//     the other's products (holding consumer 1 two k-steps behind
//     consumer 0 by a named barrier gained nothing on an H100: PERF.md).
//
// Interface: plain C, bound with ctypes; the arguments of the f32 entry
// (lm_head_lse.cu) with bf16 tensors. x is [N, H] bf16 with row stride
// sx, w is [H, V] bf16 with row stride sw (H, sx and sw multiples of 8,
// x and w 16-byte aligned: what TMA takes), lse is contiguous f32 [N],
// scratch holds 2 * splits * N floats. Returns cudaGetLastError() after
// the launches, -1 for arguments outside the kernel's range, -3 when
// cuTensorMapEncodeTiled refuses a tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;                    // threads of a warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * kWg;
constexpr int kBM = 64 * kConsumers;        // rows of a unit
constexpr int kBN = 256;                    // vocab columns of a tile
constexpr int kBK = 64;                     // k depth of a stage
constexpr int kCluster = 2;                 // blocks sharing a w tile
constexpr int kAcc = kBN / 2;               // accumulators a thread
constexpr int kWBoxes = kBN / 64;           // [64 k x 64 column] w boxes
constexpr int kShare = kWBoxes / kCluster;  // the boxes a block loads
constexpr uint32_t kXBytes = kBM * kBK * 2;
constexpr uint32_t kBoxBytes = 64 * kBK * 2;
constexpr uint32_t kWBytes = kWBoxes * kBoxBytes;
constexpr int kStages = (192 * 1024) / (kXBytes + kWBytes);
constexpr float kLog2e = 1.4426950408889634f;
// descriptor steps (16-byte units) between the four 16-deep slices of a
// stage: 32 bytes along x's K-major rows, 16 rows (2048 bytes) down w
constexpr uint64_t kKStep = 32 >> 4, kMnStep = (16 * 128) >> 4;


struct alignas(1024) Smem {
  bf16 x[kStages][kBM * kBK];
  bf16 w[kStages][kBK * kBN];
  uint64_t full[kStages], empty[kStages];
};

struct Args {
  float* part_m;      // [splits][N]
  float* part_s;
  int N, V, k_steps, ntiles, per, groups, units;
};

// -- wgmma m64nNk16, A K-major, B MN-major (transpose bit), f32 ------------

#define LSE_OPS8(c, d, i)                                                  \
  c(d[(i)]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3]), c(d[(i) + 4]),   \
      c(d[(i) + 5]), c(d[(i) + 6]), c(d[(i) + 7])
#define LSE_OPS64(c, d, i)                                                 \
  LSE_OPS8(c, d, (i)), LSE_OPS8(c, d, (i) + 8), LSE_OPS8(c, d, (i) + 16),  \
      LSE_OPS8(c, d, (i) + 24), LSE_OPS8(c, d, (i) + 32),                  \
      LSE_OPS8(c, d, (i) + 40), LSE_OPS8(c, d, (i) + 48),                  \
      LSE_OPS8(c, d, (i) + 56)
#define LSE_INOUT(x) "+f"(x)
#define LSE_OUT(x) "=f"(x)
#define LSE_REGS128                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "      \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "      \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "      \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "      \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "     \
  "%127}"

// d (64 x 256, f32) = A.B, plus d when kAccumulate. The first product of
// a tile takes no accumulator input (an input the compiler had to fill
// would make ptxas serialise the wgmma pipeline).
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_tile(float (&d)[kAcc], uint64_t da,
                                           uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " LSE_REGS128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : LSE_OPS64(LSE_INOUT, d, 0), LSE_OPS64(LSE_INOUT, d, 64)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " LSE_REGS128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : LSE_OPS64(LSE_OUT, d, 0), LSE_OPS64(LSE_OUT, d, 64)
        : "l"(da), "l"(db), "r"(0));
  }
}

#undef LSE_OPS8
#undef LSE_OPS64
#undef LSE_INOUT
#undef LSE_OUT
#undef LSE_REGS128

__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// one stage's products: the four 16-deep slices of a 64-deep k step
template <bool kFirst>
__device__ __forceinline__ void stage_products(float (&acc)[kAcc],
                                               const bf16* xs,
                                               const bf16* ws) {
  const uint64_t da = hp::desc_sw128(xs);
  const uint64_t db = hp::desc_sw128(ws, kBoxBytes);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if (kFirst && kk == 0)
      wgmma_tile<false>(acc, da, db);
    else
      wgmma_tile<true>(acc, da + kk * kKStep, db + kk * kMnStep);
  }
}

// a stage is free once every consumer warp of the cluster has released
// it: lane 0 of each warp arrives here and on the other block's barrier
__device__ __forceinline__ void release(Smem& sm, int s, int rank,
                                        int lane) {
  if (lane == 0) {
    hp::mbar_arrive(&sm.empty[s]);
    hp::mbar_arrive_peer(hp::map_rank(&sm.empty[s], rank ^ 1));
  }
}

// fold a logits tile (columns col0 ..) into rows a, b's running max m and
// this thread's share l of their denominators (quad-shared m)
__device__ __forceinline__ void fold(float (&acc)[kAcc], int col0, int V,
                                     int t, float (&m)[2], float (&l)[2]) {
  if (col0 + kBN > V) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (col0 + 8 * (i >> 2) + 2 * t + (i & 1) >= V) acc[i] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[h][j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], acc[i]);
  float base[2], corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tm = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    // finite: column col0 < V is live in every row of the tile
    const float mn = fmaxf(m[h], tm);
    base[h] = mn * kLog2e;
    corr[h] = hp::exp2_approx(fmaf(m[h], kLog2e, -base[h]));   // 0 at -inf
    m[h] = mn;
  }
  float ps[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[h][j] = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int h = (i >> 1) & 1;
    ps[h][(i >> 2) & 3] +=
        hp::exp2_approx(fmaf(acc[i], kLog2e, -base[h]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * corr[h] + ((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]));
}

__global__ void __launch_bounds__(kThreads, 1)
lse_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw, const Args a) {
  Smem& sm = hp::aligned_smem<Smem>();
  const int wg = hp::warp_uniform(threadIdx.x / kWg);
  const int rank = static_cast<int>(blockIdx.x) % kCluster;
  const int cid = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      hp::mbar_init(&sm.empty[s], kConsumers * (kWg / 32) * kCluster);
    }
    hp::mbar_init_fence();
  }
  // the other block's barriers are initialised before anything reaches
  // them
  hp::cluster_sync();

  if (wg == kConsumers) {                     // the producer
    hp::regs_dealloc<24>();
    if (threadIdx.x != kConsumers * kWg) return;
    int it = 0;                               // stages issued, all units
    for (int u = cid; u < a.units; u += clusters) {
      const int row0 = ((u % a.groups) * kCluster + rank) * kBM;
      const int t0 = (u / a.groups) * a.per;
      const int t1 = min(t0 + a.per, a.ntiles);
      for (int tile = t0; tile < t1; ++tile) {
        for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
          const int s = it % kStages;
          if (it >= kStages)
            hp::mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
          hp::mbar_arrive_tx(&sm.full[s], kXBytes + kWBytes);
          hp::tma_load_2d(sm.x[s], &tx, &sm.full[s], ks * kBK, row0);
#pragma unroll
          for (int j = rank * kShare; j < (rank + 1) * kShare; ++j)
            hp::tma_load_2d_multicast(sm.w[s] + j * 64 * kBK, &tw,
                                      &sm.full[s], tile * kBN + 64 * j,
                                      ks * kBK, (1 << kCluster) - 1);
        }
      }
    }
    // the other block's consumers arrive on this block's barriers: wait
    // for every stage's last release before the block may exit
    for (int i = it; i < it + kStages; ++i)
      if (i >= kStages)
        hp::mbar_wait(&sm.empty[i % kStages], (i / kStages - 1) & 1);
    return;
  }

  hp::regs_alloc<240>();                      // a consumer: 64 rows
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;
  for (int u = cid; u < a.units; u += clusters) {
    const int row0 = ((u % a.groups) * kCluster + rank) * kBM;
    const int split = u / a.groups;
    const int t0 = split * a.per, t1 = min(t0 + a.per, a.ntiles);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int tile = t0; tile < t1; ++tile) {
      float acc[kAcc];
      int s = it % kStages;
      hp::mbar_wait(&sm.full[s], (it / kStages) & 1);
      hp::wgmma_fence();
      stage_products<true>(acc, sm.x[s] + wg * 64 * kBK, sm.w[s]);
      hp::wgmma_commit();
      int held = s;
      ++it;
      for (int ks = 1; ks < a.k_steps; ++ks, ++it) {
        s = it % kStages;
        hp::mbar_wait(&sm.full[s], (it / kStages) & 1);
        hp::wgmma_fence();
        stage_products<false>(acc, sm.x[s] + wg * 64 * kBK, sm.w[s]);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();                  // the previous stage's group
        release(sm, held, rank, lane);
        held = s;
      }
      hp::wgmma_wait<0>();
      release(sm, held, rank, lane);
      fence_acc(acc);
      fold(acc, tile * kBN, a.V, t, m, l);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 64 * wg + 16 * w + g + 8 * h;
        if (row >= a.N) continue;
        const long long at = static_cast<long long>(split) * a.N + row;
        a.part_m[at] = m[h];
        a.part_s[at] = l[h];
      }
    }
  }
}

// lse of each row from its splits' (m, s), merged in split order
__global__ void lse_bf16_merge_kernel(const float* __restrict__ part_m,
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

// the 2-D map over (columns, rows) of a bf16 [rows, cols] matrix with
// row stride ld elements, boxes of 64 columns x box_rows rows, 128-byte
// swizzle, zero fill past the edges; false if the encoder refuses it
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              long long ld, int box_rows) {
  hp::EncodeTiled encode = hp::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// clusters that fit on the card at once (each block takes an SM's shared
// memory, and a cluster's two blocks lie in one GPC)
int resident_clusters(cudaLaunchConfig_t cfg) {
  static int clusters = 0;
  if (clusters == 0) {
    int n = 0;
    cfg.gridDim = dim3(kCluster);
    clusters = cudaOccupancyMaxActiveClusters(
                   &n, reinterpret_cast<const void*>(lse_bf16_kernel),
                   &cfg) == cudaSuccess && n > 0
                   ? n
                   : hp::sm_count() / kCluster;
  }
  return clusters;
}

}  // namespace

// scratch: 2 * splits * N floats (the splits' m, then their s); `splits`
// is the most the caller allows: the vocab tiles are dealt out evenly, so
// the kernel may use fewer
extern "C" int pt_lm_head_lse_bf16(const void* x, const void* w, void* lse,
                                   void* scratch, int N, int H, int V,
                                   long long sx, long long sw, int splits,
                                   void* stream) {
  if (H < 1 || splits < 1 || N < 1 || V < 1 || sx % 8 ||
      sw % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return -1;
  // a matrix of one row is never stepped: any legal stride will do
  if (N == 1) sx = (H + 7) / 8 * 8;
  if (H == 1) sw = (V + 7) / 8 * 8;
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, N, H, sx, kBM) || !make_map(&tw, w, H, V, sw, kBK))
    return -3;
  Args a;
  a.N = N;
  a.V = V;
  a.k_steps = (H + kBK - 1) / kBK;
  a.ntiles = (V + kBN - 1) / kBN;
  a.per = (a.ntiles + splits - 1) / splits;
  const int used = (a.ntiles + a.per - 1) / a.per;
  a.groups = ((N + kBM - 1) / kBM + kCluster - 1) / kCluster;
  a.units = a.groups * used;
  a.part_m = static_cast<float*>(scratch);
  a.part_s = a.part_m + static_cast<long long>(splits) * N;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      lse_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int clusters = resident_clusters(cfg);
  cfg.gridDim = dim3(kCluster * (a.units < clusters ? a.units : clusters));
  void* args[3] = {&tx, &tw, &a};
  err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(lse_bf16_kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_bf16_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      a.part_m, a.part_s, static_cast<float*>(lse), N, used);
  return static_cast<int>(cudaGetLastError());
}
