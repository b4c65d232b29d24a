// The int8 matrix product for Hopper (sm_90a): K6, with the rescale of
// the quantized matmul in its epilogue, and the activation quantize that
// feeds it.
//
// Replaces: paddle_tpu/ops/quant_ops.py::_pallas_int8_matmul (K6, the
// inner `kernel` launched by its pl.pallas_call): acc[M, N] = xq[M, K] @
// wq[K, N], int8 operands, exact int32 sums (|x|, |w| <= 127, so K up to
// about 2^17 cannot overflow). Around it the reference's int8_matmul
// quantizes the activations (XLA ops there, quant_ops.py:173-179) and
// rescales the sum: out = f32(acc) * ax * col. Here the rescale is K6's
// epilogue and the quantize one kernel of its own (below), so the dispatch
// runs two kernels a product and keeps no int32 tensor in device memory.
//
// What bounds it on an H100, at the five products of a GPT-2-small int8
// dispatch (M = 8 x 1024; 2MKN operations at the 1979 TOP/s of dense int8
// tensor cores against xq, wq, ax and col read once and the f32 output
// written once at 3.35 TB/s):
//   qkv       K  768 N  2304:  29.0 G ops 0.0146 ms,   83.6 MB 0.0250 ms
//   proj      K  768 N   768:   9.7 G ops 0.0049 ms,   32.1 MB 0.0096 ms
//   ffn_up    K  768 N  3072:  38.7 G ops 0.0195 ms,  109.4 MB 0.0326 ms
//   ffn_down  K 3072 N   768:  38.7 G ops 0.0195 ms,   52.7 MB 0.0157 ms
//   lm head   K  768 N 50304: 633.0 G ops 0.3198 ms, 1693.5 MB 0.5055 ms
// so all but ffn_down are bound by the bytes of their f32 output; a
// dispatch (12 x the four block products + the head) 1.50 ms by bytes
// against 1.02 ms of operations. The epilogue adds no bytes: the f32
// output is as large as the int32 one it replaces.
//
// Layout rule. PTX's wgmma takes 8-bit operands from shared memory
// K-major only (the transpose immediates exist for 16-bit types alone).
// xq [M, K] is K-major as it is; the weight [K, N] must be stored
// column-major on the card (the [N, K] transpose contiguous, i.e. strides
// (1, K)), which quant.place_int8_weights does once when int8 weights
// reach the card. The wrapper (ops/quant_ops.py) reads a row-major weight
// only through a counted per-call repack.
//
// Design (warp-specialised, persistent, the two consumers in ping-pong):
//   * an output tile is 128 rows x 128 columns; one block per SM walks
//     the tiles t = blockIdx.x, + gridDim.x, ..., rows fastest, so the
//     blocks in flight share a weight tile and the activations stay in
//     the L2;
//   * one producer warp issues TMA loads of xq [128 rows x 128 k] and w^T
//     [128 rows x 128 k] (2-D tensor maps, 128-byte swizzle, zero fill
//     past M, N and K) into a ring of 6 stages with full / empty
//     mbarriers, in tile order; the ring runs on across tiles;
//   * two consumer warpgroups take the block's tiles in turn (even and
//     odd): each runs, per stage, 4 k-slices x the tile's two 64-row
//     halves of wgmma.mma_async m64n128k32.s32.s8.s8 from shared memory
//     (the k-th 32-byte slice 32 bytes further along the swizzled rows)
//     into int32 registers, one group in flight, a stage freed once the
//     next stage's group is issued and this one has completed. Named
//     barriers make the warpgroups take turns at their mainloops, so one
//     writes its epilogue while the other's products run: the tensor
//     cores and the output stores overlap, where a shared tile would
//     leave the tensor cores idle for the whole epilogue;
//   * the epilogue writes from registers: int32 as it is (int8_matmul_i32)
//     or f32 as __fmul_rn(__fmul_rn(__int2float_rn(acc), ax[row]), col[n])
//     — cvt.rn.f32.s32, then the two products in the reference's order,
//     each rounded, no FMA contraction — so it is bitwise the plain
//     `rescale(int8_matmul_plain(xq, wq), ax, col)`; ax is per row or a
//     scalar (a static scale), and the tile's ax and col are read before
//     its first store. Rows past M and columns past N are masked.
// The 128 x 128 tile keeps a warpgroup's accumulator at 128 registers.
//
// The activation quantize (quantize_rows_cached, quantize_rows_kernel)
// is the reference's quantize, one warp a row, bitwise to
// quantize_activations_plain: dynamic ax = fmaxf(__fmul_rn(max |x|,
// fl32(1/127)), FLT_MIN) (XLA's reciprocal multiply, then the clamp at
// finfo(f32).tiny), or the calibrated static scalar clamped the same way;
// then xq = int8(clamp(rintf(__fdiv_rn(x, ax)), -127, 127)), rintf
// rounding half to even as torch.round does (the build has no
// -use_fast_math). A row of K
// <= 3072 with 16-byte aligned rows is read once into registers (float4
// loads, char4 stores); any other row is read twice, the second time
// from the cache. Its bound is 5 bytes an element (f32 in, int8 out),
// 0.80 ms a GPT-2-small dispatch (535 M activations). Activations are
// finite (a NaN or inf row is outside this contract).
//
// Interface: plain C, bound with ctypes. pt_int8_matmul: xq [M, K] int8
// with row stride lda, wq^T [N, K] int8 with row stride ldb (the
// column-major weight's stride(1)), out [M, N] row-major int32 (epilogue
// 0) or f32 (epilogue 1, with ax [M] or [1] f32 at stride ax_stride 1 or
// 0, col [N] f32). K, lda, ldb multiples of 16 and the operands 16-byte
// aligned (what TMA takes; the wrapper zero-pads K otherwise). Returns
// cudaGetLastError() after the launch, -1 for arguments it does not take,
// -3 when cuTensorMapEncodeTiled refuses a tensor map. pt_quantize_rows:
// x [M, K] f32 with row stride ldx, static_scale a device pointer to one
// f32 or null (dynamic), xq [M, K] int8 contiguous, ax [M] f32 (dynamic)
// or [1] (static); returns cudaGetLastError() or -1.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * kWg;
constexpr int kBM = 128;                  // output rows of a tile
constexpr int kBN = 128;                  // output columns of a tile
constexpr int kBK = 128;                  // k bytes of a stage
constexpr int kStages = 6;
constexpr uint32_t kABytes = kBM * kBK;   // one stage's xq box
constexpr uint32_t kBBytes = kBN * kBK;   // one stage's w^T box
constexpr uint64_t kKStep = 32 >> 4;      // a 32-byte k-slice (16 B units)
constexpr int kOrderBar = 1;              // named barriers 1, 2: turns

struct alignas(1024) Smem {
  int8_t a[kStages][kABytes];
  int8_t b[kStages][kBBytes];
  uint64_t full[kStages], empty[kStages];
};

struct Args {
  int M, N, m_tiles, tiles, k_steps;
  void* out;
  const float* ax;
  long long ax_stride;
  const float* col;
};

#define I8_ACC64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define I8_OPS64(c, d)                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]),          \
      c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]),  \
      c(d[14]), c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]),         \
      c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),         \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]),         \
      c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]),         \
      c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]), c(d[43]),         \
      c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),         \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]),         \
      c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]),         \
      c(d[62]), c(d[63])
#define I8_INOUT(x) "+r"(x)
#define I8_OUT(x) "=r"(x)

// d (64 x 128, int32) = A.B, plus d when kAccumulate; A (64 x 32) and B
// (128 x 32) int8 in shared memory, both K-major. The first product of a
// tile takes no accumulator input (an input the compiler had to fill
// would make ptxas serialise the wgmma pipeline).
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " I8_ACC64
        ", %64, %65, p;\n"
        "}\n"
        : I8_OPS64(I8_INOUT, d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " I8_ACC64
        ", %64, %65, p;\n"
        "}\n"
        : I8_OPS64(I8_OUT, d)
        : "l"(da), "l"(db), "r"(0));
  }
}

#undef I8_ACC64
#undef I8_OPS64
#undef I8_INOUT
#undef I8_OUT

__device__ __forceinline__ void fence_acc(int (&d)[2][64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[h][i]) :: "memory");
}

// named barriers between the consumer warpgroups (bar.sync waits for
// `n` threads, bar.arrive counts this warp's without waiting)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// one stage's products: 4 k-slices of 32 x the tile's two 64-row
// halves; the first stage of a tile starts the sums
template <bool kFirst>
__device__ __forceinline__ void stage_products(int (&acc)[2][64],
                                               const int8_t* a,
                                               const int8_t* b) {
  const uint64_t db = hp::desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da = hp::desc_sw128(a + h * (64 * kBK));
      if (kFirst && kk == 0)
        wgmma_s8<false>(acc[h], da, db);
      else
        wgmma_s8<true>(acc[h], da + kk * kKStep, db + kk * kKStep);
    }
  }
}

// a warpgroup's 128 x 128 tile of accumulators to out: int32, or f32
// rescaled by ax[row] and col[n] in the reference's order. The scales
// are read (through the read-only cache) before the first store.
template <bool kF32>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const int (&acc)[2][64], int m0,
                                         int n0) {
  const int w = (threadIdx.x & (kWg - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + 16 * w + g;             // + 64 * h + 8 * half
  const int c0 = n0 + 2 * t;                  // + 8 * j (+ 1)
  const bool pairs = (a.N & 1) == 0;          // 8-byte aligned pairs
  float axr[2][2], cs[kBN / 8][2];
  if (kF32) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 64 * h + 8 * half;
        axr[h][half] = r < a.M ? __ldg(a.ax + r * a.ax_stride) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        cs[j][e] = c < a.N ? __ldg(a.col + c) : 0.f;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 64 * h + 8 * half;
      if (r >= a.M) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c >= a.N) continue;
        const bool two = c + 1 < a.N;
        const int v0 = acc[h][4 * j + 2 * half];
        const int v1 = acc[h][4 * j + 2 * half + 1];
        const long long off = static_cast<long long>(r) * a.N + c;
        if (kF32) {
          const float f0 = __fmul_rn(
              __fmul_rn(__int2float_rn(v0), axr[h][half]), cs[j][0]);
          const float f1 = __fmul_rn(
              __fmul_rn(__int2float_rn(v1), axr[h][half]), cs[j][1]);
          float* o = static_cast<float*>(a.out) + off;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(f0, f1);
          } else {
            o[0] = f0;
            if (two) o[1] = f1;
          }
        } else {
          int32_t* o = static_cast<int32_t*>(a.out) + off;
          if (pairs) {
            *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[1] = v1;
          }
        }
      }
    }
  }
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const Args a) {
  Smem& sm = hp::aligned_smem<Smem>();
  const int wg = hp::warp_uniform(threadIdx.x / kWg);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      hp::mbar_init(&sm.empty[s], kWg);       // the consuming warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {                     // the producer
    hp::regs_dealloc<24>();
    if (threadIdx.x != kConsumers * kWg) return;
    int it = 0;                               // stages issued, all tiles
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int m0 = (tile % a.m_tiles) * kBM;
      const int n0 = (tile / a.m_tiles) * kBN;
      for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          hp::mbar_wait(&sm.empty[s], (it / kStages - 1) & 1);
        hp::mbar_arrive_tx(&sm.full[s], kABytes + kBBytes);
        hp::tma_load_2d(sm.a[s], &ta, &sm.full[s], ks * kBK, m0);
        hp::tma_load_2d(sm.b[s], &tb, &sm.full[s], ks * kBK, n0);
      }
    }
    return;
  }

  // a consumer: the block's tiles i = wg, wg + 2, ...; the two
  // warpgroups take turns at their mainloops (named barriers), so one's
  // epilogue runs while the other's products do. The turns also keep a
  // warpgroup from waiting on a stage's full barrier more than one phase
  // ahead of it.
  hp::regs_alloc<240>();
  const int k_steps = a.k_steps;
  int it = wg * k_steps;                      // this tile's first stage
  for (int tile = blockIdx.x + wg * gridDim.x, i = wg; tile < a.tiles;
       tile += 2 * gridDim.x, i += 2) {
    const int m0 = (tile % a.m_tiles) * kBM;
    const int n0 = (tile / a.m_tiles) * kBN;
    if (i > 0) bar_sync(kOrderBar + wg, 2 * kWg);
    int acc[2][64];
    int s = it % kStages;
    hp::mbar_wait(&sm.full[s], (it / kStages) & 1);
    hp::wgmma_fence();
    stage_products<true>(acc, sm.a[s], sm.b[s]);
    hp::wgmma_commit();
    int held = s;
    ++it;
    for (int ks = 1; ks < k_steps; ++ks, ++it) {
      s = it % kStages;
      hp::mbar_wait(&sm.full[s], (it / kStages) & 1);
      hp::wgmma_fence();
      stage_products<false>(acc, sm.a[s], sm.b[s]);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();                    // the previous stage's group
      hp::mbar_arrive(&sm.empty[held]);
      held = s;
    }
    // the next tile is the other warpgroup's: its turn
    if (tile + gridDim.x < a.tiles) bar_arrive(kOrderBar + (wg ^ 1), 2 * kWg);
    it += k_steps;                            // past the other's tile
    hp::wgmma_wait<0>();
    hp::mbar_arrive(&sm.empty[held]);
    fence_acc(acc);
    epilogue<kF32>(a, acc, m0, n0);
  }
}

// the 2-D map over (K, rows) of an int8 [rows, K] operand with row
// stride ld bytes, boxes of 128 k x 128 rows, 128-byte swizzle, zero fill
// past the edges; false if the encoder refuses it
bool make_map(CUtensorMap* map, const void* base, int rows, int K,
              long long ld) {
  hp::EncodeTiled encode = hp::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kF32>
int launch(const void* x, long long lda, const void* w, long long ldb,
           const Args& a, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!make_map(&ta, x, a.M, K, lda) || !make_map(&tb, w, a.N, K, ldb))
    return -3;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  auto kernel = int8_matmul_kernel<kF32>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.tiles < hp::sm_count() ? a.tiles : hp::sm_count();
  kernel<<<grid, kThreads, smem, stream>>>(ta, tb, a);
  return static_cast<int>(cudaGetLastError());
}

// -- the activation quantize -------------------------------------------------

constexpr int kRowsPerBlock = 8;              // one warp a row
constexpr float kInv127 = 1.0f / 127.0f;      // fl32(1/127)

__device__ __forceinline__ int8_t quantize_one(float x, float ax) {
  const float r = rintf(__fdiv_rn(x, ax));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -127.f), 127.f)));
}

__device__ __forceinline__ float row_scale(float amax,
                                           const float* static_scale) {
  return static_scale != nullptr ? fmaxf(*static_scale, FLT_MIN)
                                 : fmaxf(__fmul_rn(amax, kInv127), FLT_MIN);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows of K <= 128 * VPL with 16-byte aligned rows: the row is read once
// into registers (VPL float4 a lane), reduced, quantized from there
template <int VPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_cached(const float* __restrict__ x, long long ldx, int M,
                     int K, const float* __restrict__ static_scale,
                     int8_t* __restrict__ xq, float* __restrict__ ax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* x4 = reinterpret_cast<const float4*>(x + row * ldx);
  const int n4 = K / 4;
  float4 v[VPL];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < n4 ? __ldg(x4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                             fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
  }
  const float s = row_scale(warp_max(amax), static_scale);
  if (lane == 0 && (static_scale == nullptr || row == 0))
    ax[static_scale == nullptr ? row : 0] = s;
  char4* q4 = reinterpret_cast<char4*>(xq + static_cast<long long>(row) * K);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < n4)
      q4[c] = make_char4(quantize_one(v[i].x, s), quantize_one(v[i].y, s),
                         quantize_one(v[i].z, s), quantize_one(v[i].w, s));
  }
}

// any K and alignment: the row is read twice, the second time from the
// cache
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_kernel(const float* __restrict__ x, long long ldx, int M,
                     int K, const float* __restrict__ static_scale,
                     int8_t* __restrict__ xq, float* __restrict__ ax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + row * ldx;
  float amax = 0.f;
  if (static_scale == nullptr)
    for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(__ldg(xr + i)));
  const float s = row_scale(warp_max(amax), static_scale);
  if (lane == 0 && (static_scale == nullptr || row == 0))
    ax[static_scale == nullptr ? row : 0] = s;
  int8_t* qr = xq + static_cast<long long>(row) * K;
  for (int i = lane; i < K; i += 32) qr[i] = quantize_one(__ldg(xr + i), s);
}

}  // namespace

extern "C" int pt_int8_matmul(const void* x, long long lda, const void* w,
                              long long ldb, void* out, const void* ax,
                              long long ax_stride, const void* col, int M,
                              int K, int N, int epilogue, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || lda < K || ldb < K ||
      lda % 16 || ldb % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || (epilogue != 0 && epilogue != 1))
    return -1;
  Args a;
  a.M = M;
  a.N = N;
  a.m_tiles = (M + kBM - 1) / kBM;
  a.tiles = a.m_tiles * ((N + kBN - 1) / kBN);
  a.k_steps = (K + kBK - 1) / kBK;
  a.out = out;
  a.ax = static_cast<const float*>(ax);
  a.ax_stride = ax_stride;
  a.col = static_cast<const float*>(col);
  const auto s = static_cast<cudaStream_t>(stream);
  return epilogue == 1 ? launch<true>(x, lda, w, ldb, a, K, s)
                       : launch<false>(x, lda, w, ldb, a, K, s);
}

extern "C" int pt_quantize_rows(const void* x, long long ldx, int M, int K,
                                const void* static_scale, void* xq, void* ax,
                                void* stream) {
  if (M < 0 || K < 0 || ldx < K) return -1;
  if (M == 0) return 0;
  const bool vec = K % 4 == 0 && ldx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  const int grid = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(static_scale);
  auto* qp = static_cast<int8_t*>(xq);
  auto* ap = static_cast<float*>(ax);
  constexpr int kThreadsQ = 32 * kRowsPerBlock;
  if (vec && K <= 128 * 8)
    quantize_rows_cached<8><<<grid, kThreadsQ, 0, s>>>(xp, ldx, M, K, sp, qp,
                                                       ap);
  else if (vec && K <= 128 * 24)
    quantize_rows_cached<24><<<grid, kThreadsQ, 0, s>>>(xp, ldx, M, K, sp,
                                                        qp, ap);
  else
    quantize_rows_kernel<<<grid, kThreadsQ, 0, s>>>(xp, ldx, M, K, sp, qp,
                                                    ap);
  return static_cast<int>(cudaGetLastError());
}
