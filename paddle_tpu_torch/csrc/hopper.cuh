// Hopper (sm_90a) building blocks for the warp-specialised kernels (the
// bf16 K1-K4 in flash_attn_bf16.cu, K6 in int8_matmul.cu): mbarriers,
// TMA tile loads and the host's tensor-map encoder, thread-block cluster
// barriers and distributed shared memory (K2), the 1024-byte-aligned
// dynamic shared memory, the wgmma shared-memory descriptor and the bf16
// wgmma m64n64k16 products.
//
// Shared-memory tiles are rows of 128 bytes (64 bf16, or 128 int8 of
// K6's reduction: one 128-byte swizzle atom a row), written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B and read by wgmma through a descriptor of
// the same swizzle: a tile starts on a 1024-byte boundary, and the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8) of that row.
// Descriptors (PTX ISA, "matrix descriptor"; CUTLASS's make_gmma_desc):
//   K-major (the reduction index contiguous, e.g. K in Q.K^T): 8-row
//     groups 1024 bytes apart (SBO), LBO unused; the k-th 32-byte slice
//     of the reduction (16 bf16, or 32 int8) starts 32 bytes further (the
//     hardware applies the swizzle to the address it forms);
//   MN-major (the output column contiguous, e.g. dO in P^T.dO, read
//     with the transpose bit, bf16 only): 8-row groups of the reduction
//     1024 bytes apart (SBO), LBO the distance between 64-column groups
//     (one group here); the k-th 16-row slice starts 2048 bytes further.
// The f32 (or s32) accumulator of m64nN (a warpgroup's 64 rows) holds, in
// thread (warp w, lane l = 4g + t) register i, row 16w + g + 8 * ((i >> 1)
// & 1) and column 8 * (i >> 2) + 2t + (i & 1): mma.sync's C fragments of
// N / 8 n-tiles. Packed to bf16, two adjacent n-tiles are the register A
// fragment of the next product over those 16 columns (bf16_mma.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also raises the phase's expected transaction bytes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// raise the current phase's expected transaction bytes, no arrival
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of the given parity has completed. The spin loop
// lives inside the asm: a loop in C++ would be a (per-thread) divergent
// branch to ptxas, which then serialises the wgmma groups in flight
// across it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a value the compiler should treat as uniform across the warp (lane
// 0's), so that branches on it are not divergent to ptxas
__device__ __forceinline__ int warp_uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// -- thread-block clusters and distributed shared memory ---------------------

// every thread of every block of the cluster arrives and waits: the
// cluster-wide __syncthreads (mbarriers initialised before it are
// visible to the other blocks after it)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// two floats into another block's shared memory
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float a,
                                              float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// one arrival on an mbarrier of another block (`addr` from map_rank),
// releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(addr) : "memory");
}

// mbar_wait that acquires at cluster scope: what another block wrote
// before its releasing arrival is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAITC;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma's shared-memory operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier among `count` threads (whole warps) of the block, by id (0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// -- TMA ---------------------------------------------------------------------

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into
// shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-D tensor map at coordinates (c0, c1)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up at run time (no link against
// libcuda); nullptr when the driver does not have it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the dynamic shared memory as a T, rounded up to the 1024-byte boundary
// the 128-byte swizzle is laid out from (launches add 1024 bytes)
template <typename T>
__device__ __forceinline__ T& aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(smem_raw + pad);
}

// -- register budgets of warp-specialised roles ------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

// -- wgmma -------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at `p` (1024-byte aligned tile
// base plus the slice offset); SBO 1024 bytes, LBO 16 bytes (unused)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error
// ~2^-22, subnormal results flushed to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HP_ACC32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define HP_ACC32_OPS(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
      "+f"(d[30]), "+f"(d[31])

#define HP_OUT32_OPS(d)                                                   \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),            \
      "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),        \
      "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),   \
      "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),   \
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),   \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),   \
      "=f"(d[30]), "=f"(d[31])

// d (64 x 64, f32) = A.B, plus d when kAccumulate; A and B bf16 in
// shared memory, both K-major. The first product of a sum takes no
// accumulator input at all: an input the compiler had to fill (from
// whatever registers it picks, possibly another product's in flight)
// would make ptxas serialise the wgmma pipeline.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_ACC32
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : HP_ACC32_OPS(d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_ACC32
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : HP_OUT32_OPS(d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// d (64 x 64, f32) = A.B, plus d when kAccumulate; A and B bf16 in
// shared memory, both MN-major (the transpose bits): A's rows and B's
// columns contiguous
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_ACC32
        ", %32, %33, p, 1, 1, 1, 1;\n"
        "}\n"
        : HP_ACC32_OPS(d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_ACC32
        ", %32, %33, p, 1, 1, 1, 1;\n"
        "}\n"
        : HP_OUT32_OPS(d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// d += A.B with A (64 x 16, bf16) from registers in the m16n8k16 A
// fragment layout of each warp's 16 rows, B in shared memory MN-major
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HP_ACC32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HP_ACC32
#undef HP_ACC32_OPS
#undef HP_OUT32_OPS

}  // namespace hp
